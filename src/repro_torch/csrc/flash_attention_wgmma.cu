// Causal / full flash attention on Hopper tensor cores (sm_90a), bf16, at
// q/k and v head dims (Dh, Dv) of 64 / 64, 80 / 80 (zamba2's shared
// attention block), 128 / 128, 192 / 128 (MLA's prefill: nope 128 + rope
// 64 for q and k, v 128) and 256 / 256 (the Gemma decoder of paligemma),
// plain C interface.
//
// flash_attention_wgmma replaces, for bf16 inputs at those head dims, the
// Pallas kernel `flash_attention_kernel` (body `_kernel`) of
// src/repro/kernels/flash_attention/kernel.py, with the prefix of the jnp
// core it is the oracle of (`_blockwise_core`, src/repro/models/
// attention.py: the VLM's image patches), and at 192 / 128 the jnp
// blockwise core that MLA's prefill runs on v padded to 192
// (`mla_fwd_blockwise`); float32 and the other head dims stay on the
// 3xTF32 kernel of flash_attention.cu.  For q (B, S, H, Dh), k (B, T,
// KV, Dh) and v (B, T, KV, Dv), query head h reading KV head h / (H / KV)
// (paligemma's MQA: all 8 heads read head 0), it computes
//
//   s[r, c] = q[r] . k[c]                      (bf16 products, f32 sums)
//   p[r, c] = exp2(s[r, c] * c2 - m_r * c2),   c2 = log2(e) / sqrt(Dh)
//   o[r]    = sum_c bf16(p[r, c]) v[c] / sum_c p[r, c]
//
// over the visible keys c, with a running (max m, sum l, acc) in float32
// carried across key tiles of BK keys (128; 64 at Dh 256) and o = acc /
// max(l, 1e-30) rounded once to bf16.  The tile decides when m moves, and
// so which p round to which bf16: `ref.flash_attention_tc_ref` takes the
// same tile (`ref.tc_kv_tile`).  P is rounded to bf16 before P.V, as the
// reference's own oracle partner `_blockwise_core` does; the scores stay
// float32 and are scaled after the product (1/sqrt(Dh) is not a power of
// two, so scaling q in bf16 would add a rounding).  Key c is visible to
// query r when c < T and, if causal, c <= r or (r < prefix_len and c <
// prefix_len).  `ref.flash_attention_tc_ref` is the plain PyTorch version
// of this arithmetic.
//
//   Bound on the H100: operations.  2 * (Dh + Dv) flops per visible
//   (query, key) pair and head; at the qwen2.5-3b prefill's shape (B 1, S =
//   T = 32768, H 16, KV 2, Dh = Dv = 128, causal) 4.40e12 flops, 4.45 ms at
//   the 989 TFLOP/s bf16 tensor-core peak, against 302 MB of q, k, v and o
//   (0.09 ms at 3.35 TB/s); at deepseek-v2-lite's (H = KV = 16, Dh 192, Dv
//   128) 5.50e12 flops, 5.56 ms, against 0.6 GB; at paligemma-3b's (S = T
//   = 33024 with 256 patches as a prefix, H 8, KV 1, Dh = Dv = 256)
//   4.47e12 flops, 4.52 ms, against 304 MB; at zamba2-2.7b's (H = KV = 32,
//   Dh = Dv = 80) 5.50e12 flops, 5.56 ms, against 671 MB.  Both products
//   run on the tensor cores (`wgmma`), the only way to that rate; the K /
//   V tiles come by TMA, so no thread spends instructions on loads, and P
//   never leaves the registers.
//
//   Design.  One CTA of three warpgroups per (128-query tile, head,
//   batch), the grid 1-D with the longest causal tiles first.  Warpgroup 0
//   is the producer: it gives up registers (`setmaxnreg` 24); its thread
//   0 issues the TMA loads of the Q tile and then of the K tiles of BK
//   keys into a ring of kStages stages, its thread 32 (another warp, so
//   that neither waits behind the other) those of the V tiles into a
//   second ring.  Each stage has a `full` mbarrier and an `empty` one on
//   which every consumer warp arrives once: a K stage as soon as S over it
//   has landed, a V stage once P.V has.  Warpgroups 1 and 2 are consumers
//   of 64 query rows each (`setmaxnreg` 240).  Per key tile a consumer
//   runs S = Q K^T as Dh/16 `wgmma` m64nBKk16 with both operands in shared
//   memory (K-major), the online softmax on the f32 accumulator fragment
//   (a row's BK scores lie in the 4 lanes of a quad: max and sum by two
//   xor shuffles; the row sum is kept per thread and reduced once at the
//   end), packs P into bf16 pairs (the m64nBK accumulator fragment is the
//   register A operand of m64nDVk16, four registers per 16 keys), rescales
//   O in registers and runs O += P V as BK/16 register-A `wgmma` m64nDVk16
//   with V from shared memory as an MN-major B operand (the descriptor's
//   transpose bit).  Every tile is stored by TMA with 128-byte swizzle in
//   column blocks of 64 (Dh / 64 of them a row), a block of the 128-row Q
//   tile 16 KB and of a BK-row K or V tile BK x 128 B, the layout the
//   `wgmma` descriptors name (swizzle mode 1, 8-row groups 1024 B apart;
//   K-major steps advance 32 B inside the swizzle atom and a block's bytes
//   every 4 steps, MN-major ones 2048 B, with a V block's bytes between
//   its 64-column blocks); a head dim of 64 k + 16 (80) adds a 16-column
//   tail block with 32-byte swizzle (see below).  TMA zero-fills rows past
//   S or T, so nothing is padded; keys past T are masked.  A -inf mask is
//   applied only on tiles that need one (the diagonal, the prefix
//   boundary, the ragged tail); a row that has seen no visible key keeps m
//   = -inf and p = 0, and a tile none of a row's keys lies in leaves its
//   m, l and O as they were (corr = exp2(0) = 1).  A CTA stops at the last
//   key tile a row of its can see (with a prefix, at least up to the
//   prefix).
//
//   Schedule (`consume`, FA3's intra-warpgroup pipeline).  For key tile j
//   a consumer issues S_j, then rescales O by tile j - 1's corr and issues
//   P_{j-1} V_{j-1} behind it; `wgmma.wait_group 1` waits for S_j alone,
//   so the softmax of tile j runs while P_{j-1} V_{j-1} is on the tensor
//   cores, and P_j is packed into the A registers once that has landed
//   (the prologue issues S_0 alone, the epilogue the last P.V alone).  O's
//   rescale is skipped where every lane of a warp has corr = 1 for both
//   its rows: a product by 1 is exact.  At 80 / 80 the two consumers also
//   take turns issuing their products by two named barriers (FA3's
//   ping-pong, `ping_pong`), so that one's softmax runs under the other's
//   products.  At 256 / 256 with an even GQA group (paligemma-3b: 8 query
//   heads on 1), the CTAs run in clusters of two, query heads h and h + 1
//   of one tile, and each producer multicasts half of every K and V tile
//   into both CTAs (`kPair`): K and V are read from L2 once for the two.
//   What an output element sums is that of the loop before this
//   schedule: the same key tile, m, l, corr and bf16 P, the same order of k16 steps
//   into S and into O, so on the same inputs outputs and P are bit-equal
//   to it (`tools/time_flash.py --compare` on the H100).
//
//   What each step did, from `tools/flash_wgmma_variants.py` (each step
//   undone in turn; medians of 80 launches in one run on an H100 80GB
//   HBM3 at 700 W; ms at paligemma-3b's (1, 33024, 8, 1) 256 / 256 causal
//   with a prefix of 256, then at deepseek-v2-lite's (1, 32768, 16, 16)
//   192 / 128 causal): the loop before this schedule 7.50 and 10.00, this
//   schedule 6.80 and 9.36, SDPA 6.89 and 9.59.  At 256 / 256: without the
//   pairs 7.11, without the overlap 7.12, with O rescaled every tile 7.37,
//   with the turns 6.81.  At 192 / 128 builds of the same code read 8.86
//   to 9.36, and every step sits inside that spread (without the overlap
//   9.11, O rescaled every tile 9.28, with the turns 9.01).  The turns: at
//   80 / 80 13.22 ms with them against 15.99 without, at 64 / 64 5.17
//   against 5.02.  Rejected, in earlier runs of the tool: a third K stage
//   at 256 / 256 (224 KB fits; 6.95 ms with two stages against 7.02 with
//   three); the pairs' arrive on the partner's empty barrier with
//   `.release.cluster` semantics (9.58 ms against 6.95 without pairs: that
//   release waits on the cluster; the default `.release.cta` arrive,
//   CUTLASS's, does not); the pairs at 128 / 128 (7.39 ms against 7.37).
//   The 240 / 24 register split against the earlier 232 / 40 moved nothing
//   beyond the spread; no instantiation spills.
//
//   Shared memory (checked at compile time for every instantiation): Q plus
//   kStages K and V tiles.  At Dh 128, 32 KB + 2 x 64 KB, one CTA per SM;
//   at 192 / 128, 48 KB + 2 x 80 KB = 208 KB of the 227 KB a block may have
//   (v padded to 192 would need 240 KB: hence a separate Dv).  At 256 / 256
//   a 128-key tile would need 64 KB + 2 x 128 KB = 320 KB, so the key tile
//   is 64: 64 KB + 2 x 64 KB = 192 KB.  Registers (240 a consumer thread):
//   at 256 / 256, O is m64n256 f32, 128 a thread, S m64n64 f32, 32, and P
//   16 bf16 pairs, all live across the softmax (P of the previous tile is
//   P.V's operand in flight); at 192 / 128 O 64, S 64 and P 32.  A 64-key
//   tile pays the softmax and the O rescale per 64 keys, twice as often as
//   a 128-key one.  A head dim of 64 k + 16 (80) has exact tiles: its k
//   64-column blocks as above and a 16-column tail block of 32-byte rows
//   with 32-byte swizzle, each loaded by its own TMA map (two boxes a row
//   at 80), the tail named by descriptors of layout type 3 (K-major 8-row
//   groups 256 B apart; MN-major V 16 keys 512 B on).  S is the 5 k16
//   steps (the fifth on the tail), P.V two register-A `wgmma` a k16 step,
//   m64n64k16 on the main block and m64n16k16 on the tail, into one O of
//   40 floats a thread; the epilogue stores the 80 columns.  Q 20 KB + 2
//   x 40 KB of K and V.  A 128-column tile padded with zeros made the
//   tensor cores do 208 / 160 = 1.3x this work; five 16-column boxes a
//   row (all 32-byte swizzle) were slower than two.  Tensor maps
//   are built per call on the host (cuTensorMapEncodeTiled through the
//   runtime's driver entry point) over q, k and v with their own strides.
//
//   Left for later: persistent CTAs with a causal tile scheduler; pairs
//   of query tiles of one head sharing K / V at 192 / 128 (MHA, so no two
//   heads share one); the output through shared memory and a TMA store;
//   fp8.
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
constexpr int kStages = 2;          // depth of the K ring and of the V ring
constexpr int kThreads = 384;       // producer + two consumer warpgroups
constexpr int kProducerRegs = 24, kConsumerRegs = 240;   // setmaxnreg
constexpr int kBlockCols = 64;      // bf16 columns of one 128-byte swizzle row
constexpr uint32_t kQBlockBytes = kBQ * 128;  // one 64-column block of Q
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may have

constexpr int kTailCols = 16;       // bf16 columns of one 32-byte swizzle row

// Named barriers of the two consumers' schedule (0 is __syncthreads'):
// consumer c waits on kSchedBar + c before it issues its products.
constexpr int kSchedBar = 1;

// Whether the two consumers take those turns: at 80 / 80 only, the one
// instantiation where they gained on the H100 (tools/flash_wgmma_variants.py;
// elsewhere each consumer's overlap of its softmax with its own P.V hides
// the softmax, and the turns only added waits).
__host__ __device__ constexpr bool ping_pong(int dh, int dv) {
  return dh == 80 && dv == 80;
}

static_assert(128 * (kProducerRegs + 2 * kConsumerRegs) <= 65536,
              "the three warpgroups' registers must fit the SM's 65,536");

// The columns of a head dim in whole 64-column blocks, and in the
// 16-column tail block that 64 k + 16 (80) adds: a tile is exactly as wide
// as its head dim.
__host__ __device__ constexpr int main_cols(int d) {
  return d / kBlockCols * kBlockCols;
}
__host__ __device__ constexpr int tail_cols(int d) { return d - main_cols(d); }

// BK keys per K / V tile (a template parameter: 128, or 64 at Dh 256).
// K and V stages are released separately: K once S = Q K^T has landed, V
// once P.V has.
template <int DH, int DV, int BK>
struct Smem {
  alignas(1024) __nv_bfloat16 q[kBQ * DH];
  alignas(1024) __nv_bfloat16 k[kStages][BK * DH];
  alignas(1024) __nv_bfloat16 v[kStages][BK * DV];
  alignas(8) uint64_t q_full;
  uint64_t k_full[kStages];
  uint64_t k_empty[kStages];
  uint64_t v_full[kStages];
  uint64_t v_empty[kStages];
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

// Arrive on the barrier at the same shared-memory offset in CTA `cta` of
// the cluster (this CTA's own included).
__device__ __forceinline__ void mbar_arrive_cta(uint64_t* bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n"
      :: "r"(smem_u32(bar)), "r"(cta) : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of both CTAs of the cluster: the partner's barriers are
// initialised (at the start) and no longer written (at the end).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;\n" ::: "memory");
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

// The same box into the same shared-memory offset of both CTAs of the
// cluster (`mask` 0b11), completing on the barrier at `bar`'s offset in
// each.
__device__ __forceinline__ void tma_load_pair(void* dst, const CUtensorMap* map,
                                              uint64_t* bar, const MapOrder& m,
                                              int col, int row, int head,
                                              int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4, %5, %6}], [%2], %7;\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(col),
         "r"(map_coord(m, 1, row, head, batch)),
         "r"(map_coord(m, 2, row, head, batch)),
         "r"(map_coord(m, 3, row, head, batch)), "h"((uint16_t)0x3)
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

// The same with 32-byte swizzle (layout type 3): the tail block.
__device__ __forceinline__ uint64_t sw32_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (3ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// The two consumers' named barriers, 256 threads each: one consumer waits
// (bar.sync) while the other arrives.
__device__ __forceinline__ void sched_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}

__device__ __forceinline__ void sched_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
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

// S (64 x 64 f32), the same product over a 64-key tile.
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// O (64 x N f32) += P (64 x 16, registers) V (16 x N, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_m64n256(float (&d)[128],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127 "
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

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

__device__ __forceinline__ void wgmma_rs_m64n16(float (&d)[8],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
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

// S += Q K^T over one k16 step, by the tile's key count.
__device__ __forceinline__ void wgmma_qk(float (&s)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  wgmma_ss_m64n128(s, da, db, scale_d);
}

__device__ __forceinline__ void wgmma_qk(float (&s)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  wgmma_ss_m64n64(s, da, db, scale_d);
}

// O += P V over one k16 step, by v's head dim.
__device__ __forceinline__ void wgmma_pv(float (&o)[128],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  wgmma_rs_m64n256(o, a, db);
}

__device__ __forceinline__ void wgmma_pv(float (&o)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  wgmma_rs_m64n128(o, a, db);
}

__device__ __forceinline__ void wgmma_pv(float (&o)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  wgmma_rs_m64n64(o, a, db);
}

__device__ __forceinline__ void wgmma_pv(float (&o)[8], const uint32_t (&a)[4],
                                         uint64_t db) {
  wgmma_rs_m64n16(o, a, db);
}

// S = Q K^T over one K tile at k_addr into s (64 x BK f32), issued and
// committed, not waited for.
template <int DHD, int BK>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2], uint32_t q_addr,
                                         uint32_t q_tail, uint32_t k_addr) {
  constexpr uint32_t kKVBlockBytes = BK * 128;  // one 64-column block of K
  constexpr int kMainQK = main_cols(DHD);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kMainQK / 16; ++kk) {
    // k16 step kk: 32 bytes into the swizzle row of 64-column block kk / 4
    const uint32_t col = (kk % 4) * 32;
    wgmma_qk(s, sw128_desc(q_addr + (kk / 4) * kQBlockBytes + col, 16, 1024),
             sw128_desc(k_addr + (kk / 4) * kKVBlockBytes + col, 16, 1024),
             kk);
  }
  if (tail_cols(DHD) > 0)             // the tail block's k16 step
    wgmma_qk(s, sw32_desc(q_tail, 16, 256),
             sw32_desc(k_addr + kMainQK * BK * 2, 16, 256), kMainQK / 16);
  wgmma_commit();
}

// O += P V over one V tile at v_addr, P the bf16 pairs pk, issued and
// committed, not waited for.
template <int DVD, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[DVD / 2],
                                         uint32_t (&pk)[BK / 4],
                                         uint32_t v_addr) {
  constexpr uint32_t kKVBlockBytes = BK * 128;  // one 64-column block of V
  constexpr int kMainV = main_cols(DVD);
  fence_regs(pk);
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint32_t a[4] = {pk[4 * kk], pk[4 * kk + 1], pk[4 * kk + 2],
                           pk[4 * kk + 3]};
    if constexpr (tail_cols(DVD) == 0) {
      wgmma_pv(o, a, sw128_desc(v_addr + kk * 2048, kKVBlockBytes, 1024));
    } else {
      // columns [0, kMainV) from the 64-column blocks, the rest (O's
      // last 8 floats a thread) from the tail block: m64n16, MN-major
      // 32-byte swizzle, 16 keys two 8-row groups of 256 B
      wgmma_pv(*reinterpret_cast<float(*)[kMainV / 2]>(o), a,
               sw128_desc(v_addr + kk * 2048, kKVBlockBytes, 1024));
      wgmma_pv(*reinterpret_cast<float(*)[kTailCols / 2]>(o + kMainV / 2),
               a, sw32_desc(v_addr + kMainV * BK * 2 + kk * 512, BK * 32,
                            256));
    }
  }
  wgmma_commit();
}

// The online softmax of one landed S tile, keys k0 .. k0 + BK - 1, of a
// thread's rows row0 and row0 + 8 (a consumer's rows start at r_lo): the
// mask, the row max, corr = exp2((m_old - m_new) c2), p = exp2(s c2 - m
// c2) in place of s, and l = l corr + the tile's sum of p.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             const Params& p, int r_lo,
                                             int row0, int col0, int k0) {
  const float c2 = p.scale_log2;
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
  float mc[2];
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

  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float p0 = exp2f(fmaf(s[4 * j + 2 * i], c2, -mc[i]));
      const float p1 = exp2f(fmaf(s[4 * j + 2 * i + 1], c2, -mc[i]));
      sum[i] += p0 + p1;
      s[4 * j + 2 * i] = p0;
      s[4 * j + 2 * i + 1] = p1;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + sum[i];
}

// P of one tile (p in s) as the bf16 pairs pk, the register A operand of
// P.V (P's register pair 2 j + i packs elements 4 j + 2 i and + 1); with
// kDump also stored at p_dump[b, h, row, key].
template <int BK, bool kDump>
__device__ __forceinline__ void pack_p(const float (&s)[BK / 2],
                                       uint32_t (&pk)[BK / 4], const Params& p,
                                       int b, int h, int row0, int col0,
                                       int k0) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float p0 = s[4 * j + 2 * i], p1 = s[4 * j + 2 * i + 1];
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
}

// O *= corr, row by row.  Skipped where every lane of the warp has corr = 1
// for both its rows (no row's max moved): a product by 1 is exact, so the
// skip changes no bit.  A row that has seen no visible key has m = -inf
// and corr = 0, as before, and is multiplied.
template <int N>
__device__ __forceinline__ void rescale_o(float (&o)[N],
                                          const float (&corr)[2]) {
  if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      o[4 * j] *= corr[0];
      o[4 * j + 1] *= corr[0];
      o[4 * j + 2] *= corr[1];
      o[4 * j + 3] *= corr[1];
    }
  }
}

// Release a K or V stage: one arrive a consumer warp, once the warp's
// product over it has landed, on this CTA's empty barrier and, with
// kPair, on the partner's too (its producer multicasts into both CTAs).
template <bool kPair>
__device__ __forceinline__ void release(uint64_t* bar, uint32_t partner) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) {
    mbar_arrive(bar);
    if (kPair) mbar_arrive_cta(bar, partner);
  }
}

// One consumer warpgroup (cw 0 or 1): 64 query rows of the CTA's tile, all
// its key tiles, and the rows' output, at q/k and v head dims DHD and DVD.
// With kDump it also stores the bf16 P it feeds to P.V at p_dump[b, h,
// row, key] (rows < S, keys < T), for checking; the arithmetic is the same.
//
// Key tile j: S_j = Q K_j^T is issued, then O is rescaled by tile j - 1's
// corr and P_{j-1} V_{j-1} is issued behind it (at 80 / 80 both in this
// consumer's turn of the named barriers); the softmax of S_j runs while
// P_{j-1} V_{j-1} is in flight, and P_j is packed once P_{j-1} V_{j-1} has
// landed.  O sees the sequence O = O corr_j + P_j V_j tile after tile, as
// before this schedule, and S and O sum their k16 steps in the same
// order.  K_j's stage is released once S_j has landed, V_j's
// once P_j V_j has.  Consumer 0 takes the first turn; each turn ends with
// an arrive on the other's barrier, but consumer 1's last, so that each
// barrier sees as many arrives as waits.
template <int DHD, int DVD, int BK, bool kDump, bool kPair>
__device__ __forceinline__ void consume(Smem<DHD, DVD, BK>& sm, const Params& p,
                                        int cw, int q0, int n_kt, int b,
                                        int h, uint32_t partner) {
  constexpr int kO = DVD / 2;         // O floats per thread: DVD / 8 chunks x 4
  constexpr int kS = BK / 2;          // S floats per thread: BK / 8 chunks x 4
  // a 16-column tail block (32-byte rows) after the 64-column blocks
  constexpr int kMainQK = main_cols(DHD);
  static_assert(tail_cols(DHD) % kTailCols == 0 && tail_cols(DHD) <= kTailCols &&
                    tail_cols(DVD) == tail_cols(DHD),
                "a head dim is 64 k or 64 k + 16, the same for q/k and v");
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int r_lo = q0 + cw * 64;      // this consumer's first row
  const int row0 = r_lo + warp * 16 + lane / 4;   // rows row0 and row0 + 8
  const int col0 = 2 * (lane % 4);    // columns 8 j + col0 + {0, 1}
  // the consumer's 64 rows of each 64-column block: 64 rows x 128 bytes in
  const uint32_t q_addr = smem_u32(sm.q) + cw * 64 * 128;
  const uint32_t q_tail = smem_u32(sm.q) + kMainQK * kBQ * 2 + cw * 64 * 32;
  const int my_bar = kSchedBar + cw, other_bar = kSchedBar + 1 - cw;

  // Accumulator fragment: element 4 j + 2 i + e is (row0 + 8 i, 8 j + col0
  // + e).
  float o[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};          // per thread; the quad's sum at the end
  float corr[2];
  float s[kS];
  uint32_t pk[BK / 4];

  constexpr bool kTurns = ping_pong(DHD, DVD);
  mbar_wait(&sm.q_full, 0);
  if (kTurns && cw == 1) sched_arrive(kSchedBar);   // consumer 0 goes first
  mbar_wait(&sm.k_full[0], 0);
  if (kTurns) sched_wait(my_bar);
  issue_qk<DHD, BK>(s, q_addr, q_tail, smem_u32(sm.k[0]));
  if (kTurns && (cw == 0 || n_kt > 1)) sched_arrive(other_bar);
  wgmma_wait<0>();
  fence_regs(s);
  release<kPair>(&sm.k_empty[0], partner);
  softmax_tile<BK>(s, m, l, corr, p, r_lo, row0, col0, 0);
  pack_p<BK, kDump>(s, pk, p, b, h, row0, col0, 0);

  for (int kt = 1; kt < n_kt; ++kt) {
    const int ks = kt % kStages, vs = (kt - 1) % kStages;
    mbar_wait(&sm.k_full[ks], (kt / kStages) & 1);
    if (kTurns) sched_wait(my_bar);
    issue_qk<DHD, BK>(s, q_addr, q_tail, smem_u32(sm.k[ks]));
    rescale_o(o, corr);               // tile kt - 1's corr
    mbar_wait(&sm.v_full[vs], ((kt - 1) / kStages) & 1);
    issue_pv<DVD, BK>(o, pk, smem_u32(sm.v[vs]));
    if (kTurns && (cw == 0 || kt + 1 < n_kt)) sched_arrive(other_bar);
    wgmma_wait<1>();                  // S_kt has landed
    fence_regs(s);
    release<kPair>(&sm.k_empty[ks], partner);
    softmax_tile<BK>(s, m, l, corr, p, r_lo, row0, col0, kt * BK);
    wgmma_wait<0>();                  // P_{kt-1} V_{kt-1} has landed
    fence_regs(o);
    fence_regs(pk);
    release<kPair>(&sm.v_empty[vs], partner);
    pack_p<BK, kDump>(s, pk, p, b, h, row0, col0, kt * BK);
  }

  const int vs = (n_kt - 1) % kStages;
  rescale_o(o, corr);
  mbar_wait(&sm.v_full[vs], ((n_kt - 1) / kStages) & 1);
  issue_pv<DVD, BK>(o, pk, smem_u32(sm.v[vs]));
  wgmma_wait<0>();
  fence_regs(o);

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
    __nv_bfloat16* orow = og + (((long long)b * p.S + r) * p.H + h) * DVD + col0;
#pragma unroll
    for (int j = 0; j < DVD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = __floats2bfloat162_rn(
          o[4 * j + 2 * i] / den, o[4 * j + 2 * i + 1] / den);
  }
}

// With kPair the grid runs in clusters of two CTAs, query heads h and h + 1
// (h even) of one query tile, which read the same KV head: each CTA's
// producer loads half the column blocks of every K and V tile and
// multicasts them into both CTAs, so K and V come from L2 once for the
// two; each empty barrier then counts the consumer warps of both CTAs.
template <int DHD, int DVD, int BK, bool kDump, bool kPair>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tq_tail,
                             const __grid_constant__ CUtensorMap tk_tail,
                             const __grid_constant__ CUtensorMap tv_tail,
                             const Params p) {
  static_assert(BK == 64 || BK == 128, "S is m64n64 or m64n128");
  static_assert(DHD % 16 == 0 && DVD % 16 == 0,
                "head dims are whole k16 steps");
  // whole boxes: TMA counts the zeros it fills past DHD / DVD too
  constexpr int kMainQK = main_cols(DHD), kMainV = main_cols(DVD);
  constexpr int kKBlocks = kMainQK / kBlockCols, kVBlocks = kMainV / kBlockCols;
  static_assert(!kPair || (tail_cols(DHD) == 0 && kKBlocks % 2 == 0 &&
                           kVBlocks % 2 == 0),
                "a pair splits K and V into halves of whole column blocks");
  // consumer warps that release each stage: 8 a CTA, of both with kPair
  constexpr uint32_t kReleases = kPair ? 16 : 8;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  Smem<DHD, DVD, BK>& sm =
      *reinterpret_cast<Smem<DHD, DVD, BK>*>(smem_raw + pad);

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
  const uint32_t rank = kPair ? cluster_rank() : 0;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&sm.k_full[st], 1);
      mbar_init(&sm.k_empty[st], kReleases);
      mbar_init(&sm.v_full[st], 1);
      mbar_init(&sm.v_empty[st], kReleases);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (kPair)
    cluster_sync();
  else
    __syncthreads();

  if (threadIdx.x < 128) {            // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    // the column blocks of K and V this CTA loads: all, or its half
    constexpr int kKLoad = kPair ? kKBlocks / 2 : kKBlocks;
    constexpr int kVLoad = kPair ? kVBlocks / 2 : kVBlocks;
    if (threadIdx.x == 0) {           // Q, then the K ring
      mbar_expect_tx(&sm.q_full, kBQ * DHD * 2);
#pragma unroll
      for (int c = 0; c < kKBlocks; ++c)
        tma_load(sm.q + c * kBQ * kBlockCols, &tq, &sm.q_full, p.oq,
                 c * kBlockCols, q0, h, b);
      if (tail_cols(DHD) > 0)
        tma_load(sm.q + kMainQK * kBQ, &tq_tail, &sm.q_full, p.oq, kMainQK,
                 q0, h, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % kStages;
        mbar_wait(&sm.k_empty[st], ((kt / kStages) & 1) ^ 1);
        mbar_expect_tx(&sm.k_full[st], BK * DHD * 2);   // both halves
#pragma unroll
        for (int i = 0; i < kKLoad; ++i) {
          const int c = rank * kKLoad + i;
          if (kPair)
            tma_load_pair(sm.k[st] + c * BK * kBlockCols, &tk, &sm.k_full[st],
                          p.ok, c * kBlockCols, kt * BK, kvh, b);
          else
            tma_load(sm.k[st] + c * BK * kBlockCols, &tk, &sm.k_full[st],
                     p.ok, c * kBlockCols, kt * BK, kvh, b);
        }
        if (tail_cols(DHD) > 0)
          tma_load(sm.k[st] + kMainQK * BK, &tk_tail, &sm.k_full[st], p.ok,
                   kMainQK, kt * BK, kvh, b);
      }
    } else if (threadIdx.x == 32) {   // the V ring, from another warp
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % kStages;
        mbar_wait(&sm.v_empty[st], ((kt / kStages) & 1) ^ 1);
        mbar_expect_tx(&sm.v_full[st], BK * DVD * 2);
#pragma unroll
        for (int i = 0; i < kVLoad; ++i) {
          const int c = rank * kVLoad + i;
          if (kPair)
            tma_load_pair(sm.v[st] + c * BK * kBlockCols, &tv, &sm.v_full[st],
                          p.ov, c * kBlockCols, kt * BK, kvh, b);
          else
            tma_load(sm.v[st] + c * BK * kBlockCols, &tv, &sm.v_full[st],
                     p.ov, c * kBlockCols, kt * BK, kvh, b);
        }
        if (tail_cols(DVD) > 0)
          tma_load(sm.v[st] + kMainV * BK, &tv_tail, &sm.v_full[st], p.ov,
                   kMainV, kt * BK, kvh, b);
      }
    }
  } else {                            // two consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
    consume<DHD, DVD, BK, kDump, kPair>(sm, p, threadIdx.x / 128 - 1, q0,
                                        n_kt, b, h, rank ^ 1);
  }
  if (kPair) cluster_sync();          // the partner no longer arrives here
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
// box is 64 columns x `box_rows` rows, 128-byte swizzled, or with `tail`
// 16 columns, 32-byte swizzled.  Returns a CUresult.
int make_map(CUtensorMap* map, MapOrder* order, const void* ptr, int dh,
             int rows, int heads, int batch, const long long* st,
             int box_rows, bool tail = false) {
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
  cuuint32_t box[4] = {(cuuint32_t)(tail ? kTailCols : kBlockCols), 1, 1, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  int pos[3];
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = (cuuint64_t)ext[idx[i]];
    strides[i] = (cuuint64_t)(str[idx[i]] * 2);
    pos[idx[i]] = i + 1;
    if (idx[i] == 0) box[i + 1] = (cuuint32_t)box_rows;
  }
  order->row = pos[0];
  order->head = pos[1];
  order->batch = pos[2];
  return (int)encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                     const_cast<void*>(ptr), dims, strides, box, ones,
                     CU_TENSOR_MAP_INTERLEAVE_NONE,
                     tail ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_128B,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// With kPair, in clusters of two CTAs (the caller checks that H / KV is
// even, so that heads h and h + 1 of a cluster read one KV head).
template <int DHD, int DVD, int BK, bool kDump, bool kPair>
int launch(const void* q, const void* k, const void* v,
           const long long* strides, Params& p, cudaStream_t stream) {
  static_assert(sizeof(Smem<DHD, DVD, BK>) + 1024 <= kSmemLimit,
                "the Q tile and two K / V stages must fit a block's shared "
                "memory");
  const long long blocks = (long long)((p.S + kBQ - 1) / kBQ) * p.B * p.H;
  if (blocks == 0) return 0;
  if (p.T == 0) {                     // no key: o = 0 / max(0, 1e-30)
    cudaMemsetAsync(p.o, 0, (size_t)p.B * p.S * p.H * DVD * 2, stream);
    return (int)cudaGetLastError();
  }
  CUtensorMap tq, tk, tv;
  const long long sq[3] = {strides[1], strides[2], strides[0]};
  const long long sk[3] = {strides[4], strides[5], strides[3]};
  const long long sv[3] = {strides[7], strides[8], strides[6]};
  int rc = make_map(&tq, &p.oq, q, DHD, p.S, p.H, p.B, sq, kBQ);
  if (rc == 0) rc = make_map(&tk, &p.ok, k, DHD, p.T, p.KV, p.B, sk, BK);
  if (rc == 0) rc = make_map(&tv, &p.ov, v, DVD, p.T, p.KV, p.B, sv, BK);
  CUtensorMap tq_tail = tq, tk_tail = tk, tv_tail = tv;   // unread at 64 k
  if (tail_cols(DHD) > 0) {
    if (rc == 0)
      rc = make_map(&tq_tail, &p.oq, q, DHD, p.S, p.H, p.B, sq, kBQ, true);
    if (rc == 0)
      rc = make_map(&tk_tail, &p.ok, k, DHD, p.T, p.KV, p.B, sk, BK, true);
    if (rc == 0)
      rc = make_map(&tv_tail, &p.ov, v, DVD, p.T, p.KV, p.B, sv, BK, true);
  }
  if (rc != 0) return rc;
  const int smem = (int)sizeof(Smem<DHD, DVD, BK>) + 1024;
  const auto kernel = flash_attention_wgmma_kernel<DHD, DVD, BK, kDump, kPair>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = kPair ? 2 : 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = kPair ? 1 : 0;
  cudaLaunchKernelEx(&cfg, kernel, tq, tk, tv, tq_tail, tk_tail, tv_tail, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, S, H, dh), k (B, T, KV, dh), v (B, T, KV, dv) bf16 on the device
// with unit stride on the head dim and the other strides (elements) in
// `strides`: q's batch, seq, head, then k's, then v's, each a multiple of
// 8, pointers 16-byte aligned.  o (B, S, H, dv) contiguous bf16.  (dh, dv)
// is (64, 64), (80, 80), (128, 128), (192, 128) or (256, 256).  scale_log2 = log2(e) / sqrt(dh)
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
    return dump ? launch<64, 64, 128, true, false>(q, k, v, strides, p, st)
                : launch<64, 64, 128, false, false>(q, k, v, strides, p, st);
  if (dh == 80 && dv == 80)        // a 64-column block and a 16-column tail
    return dump ? launch<80, 80, 128, true, false>(q, k, v, strides, p, st)
                : launch<80, 80, 128, false, false>(q, k, v, strides, p, st);
  if (dh == 128 && dv == 128)
    return dump ? launch<128, 128, 128, true, false>(q, k, v, strides, p, st)
                : launch<128, 128, 128, false, false>(q, k, v, strides, p, st);
  if (dh == 192 && dv == 128)
    return dump ? launch<192, 128, 128, true, false>(q, k, v, strides, p, st)
                : launch<192, 128, 128, false, false>(q, k, v, strides, p, st);
  if (dh == 256 && dv == 256) {
    // heads h and h + 1 share a KV head: pairs of CTAs share K / V loads
    if (KV > 0 && H % KV == 0 && (H / KV) % 2 == 0)
      return dump ? launch<256, 256, 64, true, true>(q, k, v, strides, p, st)
                  : launch<256, 256, 64, false, true>(q, k, v, strides, p, st);
    return dump ? launch<256, 256, 64, true, false>(q, k, v, strides, p, st)
                : launch<256, 256, 64, false, false>(q, k, v, strides, p, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
