// Flash-attention forward, causal / sliding-window GQA, bf16 in and out:
//   out[b,i,h] = softmax_j(q[b,i,h] . k[b,j,h/g] / sqrt(Dh)) v[b,j,h/g],
// g = Hq / Hkv,
// over the keys j with j < Sk, plus i >= j when causal, plus i - j < window
// when windowed (query and key indices are the positions).  The softmax is
// fp32 and online; the denominator is clamped at 1e-30.  A query row with no
// key to attend (only possible when Sq > Sk under a window) is written as 0.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_kernel).  That kernel walks a sequential (B*Hq, nq, nk) grid, keeps m, l
// and the accumulator in VMEM scratch across the k axis and pads Dh to 128
// lanes.  On Hopper the blocks run in parallel and in no order, so nothing is
// carried between them: one block of 4 warps owns a (batch*head, 64-query)
// tile and loops over the key tiles itself.
//
// Design.
//  * The Q tile (64 x D) and each K tile (BN x D) are staged in shared memory
//    as read from kv head h / group, so K and V are never expanded; V is
//    stored transposed (D x BN) so that its mma B fragments are 32-bit loads.
//    Rows are padded by 8 bf16 so the fragment loads hit 32 distinct banks.
//  * Each warp owns 16 query rows.  S = Q K^T and O += P V are
//    mma.sync.m16n8k16 (bf16 operands, fp32 accumulation); P goes from the S
//    accumulators to A fragments in registers (the m16n8 C layout of two
//    adjacent key blocks is the m16k16 A layout), rounded to bf16.  The
//    running max, the row sums and the accumulator stay in fp32 registers.
//  * Key tiles wholly above the causal diagonal, or wholly outside the
//    window, are never loaded: they contribute exactly zero.  Query tiles are
//    issued heaviest (last) first so that the causal triangle balances.
//  * D (64 / 128 / 256) is a template parameter.  A smaller head_dim (16, 32,
//    120, ...; a multiple of 8) runs in the next template with masked loads
//    that zero the missing columns, never a padded copy.  D = 256 halves the
//    key tile to 32 rows to keep the accumulator in registers; its 70 KB of
//    shared memory needs cudaFuncAttributeMaxDynamicSharedMemorySize.
//
// Bound (qwen2.5-3b prefill: B 4, S 2048, Hq 16, Hkv 2, Dh 128, causal):
// 4 * B * Hq * S^2 * Dh / 2 = 68.7 GFLOP over 989 TFLOP/s of bf16 tensor
// cores is 0.069 ms; Q + K + V + O = 75.5 MB over 3.35 TB/s is 0.023 ms.  So
// the kernel is bound by operations: the tensor cores are the resource, and
// keeping S and P out of device memory (never materialising the S x S
// scores) is what the design buys.  mma.sync without a load pipeline reaches
// a fraction of the wgmma peak; TMA, wgmma and warp specialisation are later
// work.
//
// Launch: on the caller's stream, no synchronisation, no allocation.
// Returns cudaGetLastError() as an int.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockM = kWarps * 16;      // query rows per block
constexpr int kPad = 8;                   // bf16 of padding per smem row
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
struct Tile {
  static constexpr int BN = D > 128 ? 32 : 64;   // key rows per tile
  static constexpr int QK_STRIDE = D + kPad;     // sQ, sK row stride
  static constexpr int V_STRIDE = BN + kPad;     // sVt row stride
  static constexpr int SMEM_ELEMS =
      kBlockM * QK_STRIDE + BN * QK_STRIDE + D * V_STRIDE;
  static constexpr int SMEM_BYTES = SMEM_ELEMS * 2;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ out, int sq, int sk,
                       int hq, int hkv, int dh, int causal, int window,
                       float scale_log2) {
  using T = Tile<D>;
  constexpr int BN = T::BN;
  constexpr int QS = T::QK_STRIDE;
  constexpr int VS = T::V_STRIDE;
  constexpr int CHUNKS = D / 8;               // 16-byte chunks per row
  constexpr int NT = BN / 8;                  // key n-tiles of S
  constexpr int DT = D / 8;                   // d n-tiles of O

  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  __nv_bfloat16* sQ = smem;
  __nv_bfloat16* sK = sQ + kBlockM * QS;
  __nv_bfloat16* sVt = sK + BN * QS;

  const int bh = blockIdx.x;
  const int b = bh / hq;
  const int h = bh % hq;
  const int hk = h / (hq / hkv);
  const int qb = gridDim.y - 1 - blockIdx.y;  // heaviest query tile first
  const int q0 = qb * kBlockM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;                    // mma group (row in fragment)
  const int t = lane & 3;                     // thread in group
  const int dchunks = dh / 8;
  const int64_t q_row = (int64_t)hq * dh;     // elements between positions
  const int64_t kv_row = (int64_t)hkv * dh;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  // stage the Q tile (rows past Sq and columns past Dh are zeros)
  for (int idx = tid; idx < kBlockM * CHUNKS; idx += kThreads) {
    const int r = idx / CHUNKS, c = idx % CHUNKS;
    const int i = q0 + r;
    uint4 val = zero;
    if (i < sq && c < dchunks)
      val = *reinterpret_cast<const uint4*>(
          q + ((int64_t)b * sq + i) * q_row + (int64_t)h * dh + c * 8);
    *reinterpret_cast<uint4*>(sQ + r * QS + c * 8) = val;
  }

  // the key tiles this query tile can see
  const int q_last = min(q0 + kBlockM, sq) - 1;
  int k_end = sk;
  if (causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 - window + 1);
  k_begin = (k_begin / BN) * BN;

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m_row[2] = {neg_inf(), neg_inf()};    // rows g and g + 8
  float l_row[2] = {0.f, 0.f};                // this thread's partial sums
  const int row0 = q0 + warp * 16 + g;        // query index of row g

  for (int k0 = k_begin; k0 < k_end; k0 += BN) {
    __syncthreads();                          // previous tile consumed
    for (int idx = tid; idx < BN * CHUNKS; idx += kThreads) {
      const int r = idx / CHUNKS, c = idx % CHUNKS;
      const int j = k0 + r;
      uint4 val = zero;
      if (j < sk && c < dchunks)
        val = *reinterpret_cast<const uint4*>(
            k + ((int64_t)b * sk + j) * kv_row + (int64_t)hk * dh + c * 8);
      *reinterpret_cast<uint4*>(sK + r * QS + c * 8) = val;
    }
    for (int idx = tid; idx < BN * CHUNKS; idx += kThreads) {
      const int r = idx % BN, c = idx / BN;   // neighbours on neighbour keys
      const int j = k0 + r;
      uint4 val = zero;
      if (j < sk && c < dchunks)
        val = *reinterpret_cast<const uint4*>(
            v + ((int64_t)b * sk + j) * kv_row + (int64_t)hk * dh + c * 8);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int x = 0; x < 8; ++x) sVt[(c * 8 + x) * VS + r] = e[x];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    const __nv_bfloat16* qw = sQ + (warp * 16 + g) * QS + 2 * t;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      a[0] = lds32(qw + kk * 16);
      a[1] = lds32(qw + 8 * QS + kk * 16);
      a[2] = lds32(qw + kk * 16 + 8);
      a[3] = lds32(qw + 8 * QS + kk * 16 + 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* kr = sK + (nt * 8 + g) * QS + kk * 16 + 2 * t;
        mma_bf16(s[nt], a, lds32(kr), lds32(kr + 8));
      }
    }

    // mask, scale (base 2), and the running max of rows g and g + 8
    float m_new[2] = {m_row[0], m_row[1]};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = row0 + (e >> 1) * 8;
        const int j = k0 + nt * 8 + 2 * t + (e & 1);
        bool ok = j < sk;
        if (causal) ok = ok && i >= j;
        if (window > 0) ok = ok && i - j < window;
        s[nt][e] = ok ? s[nt][e] * scale_log2 : neg_inf();
        m_new[e >> 1] = fmaxf(m_new[e >> 1], s[nt][e]);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffff, m_new[r], 1));
      m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffff, m_new[r], 2));
      // a row with nothing to attend yet keeps a finite base: exp2(-inf) = 0
      const float base = m_new[r] == neg_inf() ? 0.f : m_new[r];
      corr[r] = exp2f(m_row[r] - base);
      m_row[r] = m_new[r];
      l_row[r] *= corr[r];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        s[nt][2 * r] = exp2f(s[nt][2 * r] - base);
        s[nt][2 * r + 1] = exp2f(s[nt][2 * r + 1] - base);
        l_row[r] += s[nt][2 * r] + s[nt][2 * r + 1];
      }
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      acc[dt][0] *= corr[0];
      acc[dt][1] *= corr[0];
      acc[dt][2] *= corr[1];
      acc[dt][3] *= corr[1];
    }

    // O += P V: P's C fragments of key blocks 2kk, 2kk+1 are an A fragment
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const __nv_bfloat16* vr = sVt + (dt * 8 + g) * VS + kk * 16 + 2 * t;
        mma_bf16(acc[dt], a, lds32(vr), lds32(vr + 8));
      }
    }
  }

  // finish: full row sums across the quad, normalise, write bf16
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_row[r] += __shfl_xor_sync(0xffffffff, l_row[r], 1);
    l_row[r] += __shfl_xor_sync(0xffffffff, l_row[r], 2);
  }
  const float inv[2] = {1.f / fmaxf(l_row[0], 1e-30f),
                        1.f / fmaxf(l_row[1], 1e-30f)};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + r * 8;
    if (i >= sq) continue;
    __nv_bfloat16* o = out + ((int64_t)b * sq + i) * q_row + (int64_t)h * dh;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int d = dt * 8 + 2 * t;
      if (d < dh)   // dh is a multiple of 8, so d + 1 < dh too
        *reinterpret_cast<uint32_t*>(o + d) =
            pack_bf16(acc[dt][2 * r] * inv[r], acc[dt][2 * r + 1] * inv[r]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int64_t b,
           int64_t sq, int64_t sk, int64_t hq, int64_t hkv, int64_t dh,
           int64_t causal, int64_t window, cudaStream_t stream) {
  constexpr int bytes = Tile<D>::SMEM_BYTES;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((unsigned)(b * hq),
                  (unsigned)((sq + kBlockM - 1) / kBlockM));
  const float scale_log2 = kLog2e / sqrtf((float)dh);
  flash_attention_kernel<D><<<grid, kThreads, bytes, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, (int)sq, (int)sk,
      (int)hq, (int)hkv, (int)dh, (int)causal, (int)window, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int64_t b,
                                     int64_t sq, int64_t sk, int64_t hq,
                                     int64_t hkv, int64_t dh, int64_t causal,
                                     int64_t window, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || hkv <= 0 || hq % hkv != 0 ||
      dh <= 0 || dh % 8 != 0 || dh > 256 || sq > 0x7fffffff ||
      sk > 0x7fffffff || (sq + kBlockM - 1) / kBlockM > 65535 ||
      b * hq > 0x7fffffff || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dh <= 64)
    return launch<64>(q, k, v, out, b, sq, sk, hq, hkv, dh, causal, window, s);
  if (dh <= 128)
    return launch<128>(q, k, v, out, b, sq, sk, hq, hkv, dh, causal, window,
                       s);
  return launch<256>(q, k, v, out, b, sq, sk, hq, hkv, dh, causal, window, s);
}
