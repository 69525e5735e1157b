// Causal / full flash attention (online softmax, GQA by index) for Hopper
// (sm_90a), plain C interface.
//
// flash_attention replaces the Pallas kernel `flash_attention_kernel` (body
// `_kernel`) of src/repro/kernels/flash_attention/kernel.py, whose oracle
// partner is `_blockwise_core` in src/repro/models/attention.py.  For q
// (B, S, H, Dh) and k, v (B, T, KV, Dh), query head h reading KV head
// h / (H / KV), it computes with the Pallas kernel's arithmetic
//
//   s[r, c] = (float(q[r]) * scale) . float(k[c])          (float32)
//   o[r]    = sum_c exp(s[r, c] - m_r) v[c] / sum_c exp(s[r, c] - m_r)
//
// over the visible keys c, with a running (max m, sum l, acc) in float32
// carried across 64-key tiles, and o = acc / max(l, 1e-30) cast once to the
// input type (bf16 or f32).  Key c is visible to query r when c < T and,
// if causal, c <= r or (r < prefix_len and c < prefix_len).
//
//   Bound on the H100: operations.  The work is 4 * Dh flops per visible
//   (query, key) pair and head (S = q k^T and P.V); at the prefill's shape
//   (B 1, S = T = 32768, H 16, KV 2, Dh 128, causal) that is 4.40e12, 4.45 ms
//   at the 989 TFLOP/s bf16 tensor-core peak, against 302 MB of q, k, v and
//   o, 0.09 ms at 3.35 TB/s.  This kernel runs its products on CUDA cores
//   (float32 FFMA, 67 TFLOP/s), so it cannot come within 15x of that bound;
//   tensor cores (`wgmma` on bf16 tiles fed by TMA) are the redesign.
//
//   Design: register-tiled, in the style of acim_matmul.cu.  One CTA of 128
//   threads per (64-query tile, head, batch); the grid is 1-D with the
//   longest causal tiles first, so the short ones fill the tail.  The
//   scaled q tile stays in shared memory (transposed, d-major) for the whole
//   CTA; each 64-key tile of k (transposed) and v (row-major) is staged in
//   shared memory as float32, keys past T zero-filled and masked.  Thread
//   (ty, tx) owns query rows ty*4 .. ty*4+3 and score columns
//   tx*4 + 32g + e (g < 2, e < 4), so one row's 64 scores lie in the 8 lanes
//   of one row group and the row max and row sum are three xor shuffles.
//   P goes to shared memory (transposed) for the P.V product; its rows are
//   written and read by one warp only, so a __syncwarp orders them.  The O
//   accumulator, 4 rows x Dh/8 columns (64 floats at Dh 128), stays in
//   registers.  With 112 KB of shared memory at Dh 128, two CTAs share an
//   SM.  Causal CTAs stop at the last tile a row of theirs can see (with a
//   prefix, at least up to the prefix).  Exact `expf` (no fast math) and
//   IEEE division, as the plain version.  A masked score is -inf and its
//   p is exactly 0; a row that has seen no visible key keeps m = -inf and
//   p = 0 (the Pallas kernel's -1e30 gives the same result for these masks,
//   where every row sees key 0 in the first tile).  Offsets are int64.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;           // query rows per CTA
constexpr int kBK = 64;           // keys per shared-memory tile
constexpr int kThreads = 128;     // 16 row groups x 8 column groups
constexpr int kRows = 4;          // query rows per thread
constexpr int kCols = 8;          // score columns per thread

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long qsb, qss, qsh;        // strides in elements: batch, seq, head
  long long ksb, kss, ksh;
  long long vsb, vss, vsh;
  int B, S, T, H, KV;
  int causal, prefix_len;
  float scale;
};

// Eight consecutive elements (16-byte aligned) as float32.
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {     // element 2i is the low half of word i
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int DH, typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(Params p) {
  constexpr int kVec = DH >= 32 ? 4 : 2;      // O columns per vector
  constexpr int kOCols = DH / 8;              // O columns per thread
  constexpr int kGroups = kOCols / kVec;      // vectors per thread and row
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [DH][kBQ]   scaled q, transposed
  float* ks = qs + DH * kBQ;        // [DH][kBK]   k tile, transposed
  float* vs = ks + DH * kBK;        // [kBK][DH]   v tile
  float* ps = vs + kBK * DH;        // [kBK][kBQ]  p tile, transposed

  const int tid = threadIdx.x;
  const int tx = tid & 7;
  const int ty = tid >> 3;
  const int bh_count = p.B * p.H;
  const int n_qt = (p.S + kBQ - 1) / kBQ;
  const int qt = n_qt - 1 - (int)(blockIdx.x / bh_count);
  const int bh = (int)(blockIdx.x % bh_count);
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const int q0 = qt * kBQ;
  const T* qg = static_cast<const T*>(p.q) + b * p.qsb + h * p.qsh;
  const T* kg = static_cast<const T*>(p.k) + b * p.ksb + kvh * p.ksh;
  const T* vg = static_cast<const T*>(p.v) + b * p.vsb + kvh * p.vsh;

  for (int i = tid; i < kBQ * DH / 8; i += kThreads) {
    const int r = i % kBQ, d8 = (i / kBQ) * 8;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (q0 + r < p.S) load8(qg + (long long)(q0 + r) * p.qss + d8, x);
#pragma unroll
    for (int e = 0; e < 8; ++e) qs[(d8 + e) * kBQ + r] = x[e] * p.scale;
  }

  // keys [0, kend) can be visible to some row of this tile
  int kend = p.T;
  if (p.causal) {
    kend = min(q0 + kBQ, p.S);
    if (q0 < p.prefix_len) kend = max(kend, p.prefix_len);
    kend = min(kend, p.T);
  }
  const int n_kt = (kend + kBK - 1) / kBK;

  float o[kRows][kOCols], m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kOCols; ++j) o[i][j] = 0.f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                // the previous tile's ks / vs reads
    for (int i = tid; i < kBK * DH / 8; i += kThreads) {
      const int c = i % kBK, d8 = (i / kBK) * 8;
      float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (k0 + c < p.T) load8(kg + (long long)(k0 + c) * p.kss + d8, x);
#pragma unroll
      for (int e = 0; e < 8; ++e) ks[(d8 + e) * kBK + c] = x[e];
    }
    for (int i = tid; i < kBK * DH / 8; i += kThreads) {
      const int c = i / (DH / 8), d8 = (i % (DH / 8)) * 8;
      float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (k0 + c < p.T) load8(vg + (long long)(k0 + c) * p.vss + d8, x);
      *reinterpret_cast<float4*>(&vs[c * DH + d8]) =
          make_float4(x[0], x[1], x[2], x[3]);
      *reinterpret_cast<float4*>(&vs[c * DH + d8 + 4]) =
          make_float4(x[4], x[5], x[6], x[7]);
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float4 a4 = *reinterpret_cast<const float4*>(&qs[d * kBQ + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ks[d * kBK + tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&ks[d * kBK + 32 + tx * 4]);
      const float a[kRows] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[kCols] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(a[i], bv[j], s[i][j]);
    }

    // mask, online softmax; one row's 64 scores are in 8 adjacent lanes
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = k0 + (j / 4) * 32 + tx * 4 + (j % 4);
        const bool vis = c < p.T && (!p.causal || c <= r ||
                                     (r < p.prefix_len && c < p.prefix_len));
        if (!vis) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = expf(m[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[i][j] = expf(s[i][j] - m_use);
        sum += s[i][j];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kOCols; ++j) o[i][j] *= corr;
    }

#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = (j / 4) * 32 + tx * 4 + (j % 4);
      *reinterpret_cast<float4*>(&ps[c * kBQ + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncwarp();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 a4 = *reinterpret_cast<const float4*>(&ps[c * kBQ + ty * 4]);
      const float a[kRows] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const float* vp = &vs[c * DH + g * 8 * kVec + tx * kVec];
        float vv[kVec];
        if constexpr (kVec == 4) {
          const float4 v4 = *reinterpret_cast<const float4*>(vp);
          vv[0] = v4.x; vv[1] = v4.y; vv[2] = v4.z; vv[3] = v4.w;
        } else {
          const float2 v2 = *reinterpret_cast<const float2*>(vp);
          vv[0] = v2.x; vv[1] = v2.y;
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            o[i][g * kVec + e] = fmaf(a[i], vv[e], o[i][g * kVec + e]);
      }
    }
  }

  T* og = static_cast<T*>(p.o);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= p.S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = og + (((long long)b * p.S + r) * p.H + h) * DH;
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        store(orow + g * 8 * kVec + tx * kVec + e, o[i][g * kVec + e] / den);
  }
}

template <int DH, typename T>
int launch(const Params& p, cudaStream_t stream) {
  const int smem = (2 * DH * kBQ + kBK * DH + kBK * kBQ) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<DH, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks =
      (long long)((p.S + kBQ - 1) / kBQ) * p.B * p.H;
  if (blocks == 0) return 0;
  flash_attention_kernel<DH, T><<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Params& p, int dh, cudaStream_t stream) {
  switch (dh) {
    case 16: return launch<16, T>(p, stream);
    case 32: return launch<32, T>(p, stream);
    case 64: return launch<64, T>(p, stream);
    case 128: return launch<128, T>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, S, H, Dh), k / v (B, T, KV, Dh) on the device with unit stride on
// Dh and the other strides (elements) in `strides`: q's batch, seq, head,
// then k's, then v's, each a multiple of 8, pointers 16-byte aligned.
// o (B, S, H, Dh) contiguous.  bf16 != 0: bfloat16 tensors, else float32.
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
  const cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? dispatch<__nv_bfloat16>(p, dh, st) : dispatch<float>(p, dh, st);
}

}  // extern "C"
