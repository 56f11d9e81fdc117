// Flash-attention forward, causal / sliding-window GQA, bf16 in and out:
//   out[b,i,h] = softmax_j(q[b,i,h] . k[b,j,h/g] / sqrt(Dh)) v[b,j,h/g],
// g = Hq / Hkv,
// over the keys j with j < Sk, plus p >= j when causal, plus p - j < window
// when windowed, where p = i + q_offset is query row i's position (key
// indices are the positions; a sequence-parallel rank's rows start at
// q_offset in the gathered keys, and 0 is the whole sequence).  The softmax is
// fp32 and online; the denominator is clamped at 1e-30.  A query row with no
// key to attend (only possible when Sq > Sk under a window) is written as 0.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_kernel).  That kernel walks a sequential (B*Hq, nq, nk) grid, keeps m, l
// and the accumulator in VMEM scratch across the k axis and pads Dh to 128
// lanes.  On Hopper the blocks run in parallel and in no order, so nothing is
// carried between them: one block owns a (batch*head, 128-query) tile and
// loops over the key tiles itself.
//
// Bound (qwen2.5-3b prefill: B 4, S 2048, Hq 16, Hkv 2, Dh 128, causal):
// 4 * B * Hq * S^2 * Dh / 2 = 68.7 GFLOP over 989 TFLOP/s of bf16 tensor
// cores is 0.069 ms; Q + K + V + O = 75.5 MB over 3.35 TB/s is 0.023 ms.  So
// the kernel is bound by operations: only wgmma reaches the tensor cores'
// full rate, and the loads and the softmax have to hide behind it.
//
// Design (FlashAttention-3's shape).
//  * Warp specialisation: 3 warpgroups.  Warpgroup 0 is the producer: it
//    drops to 40 registers (setmaxnreg) and one of its threads issues every
//    TMA load.  Warpgroups 1 and 2 are consumers of 64 query rows each
//    (wgmma's M); they take 232 registers.
//  * TMA: Q, K, V and O are each described by one 4-D tensor map over the
//    contiguous (B, S, H, Dh) layout, dims (Dh, H, S, B), built on the host
//    per call from the geometry the wrapper passes (flash_attention.
//    tensor_map_geometry).  A box is the rows of one head, 64 columns (128
//    bytes, the 128-byte swizzle's span) wide, so a tile of Dh 128 (256) is
//    2 (4) boxes.  K and V are read from kv head h / g: never expanded.
//    Rows past S and columns past Dh are zero-filled by the hardware, which
//    serves Dh 16 / 32 / 120 inside the 64 / 128 templates and the ragged
//    last tiles without masked loads or a padded copy.
//  * Pipeline: Q once, then a ring of 2 K/V stages in shared memory, each
//    guarded by a full mbarrier (TMA transaction bytes) and an empty one
//    (one arrival per consumer warp), so the next tile loads while the
//    current one is multiplied.
//  * wgmma: S = Q K^T reads Q and K from shared memory (both K-major, the
//    128-byte swizzle in the descriptor matching the TMA box).  O += P V
//    reads P from registers (the S accumulator's m64nN layout, rounded to
//    bf16, is wgmma's A fragment) and V from shared memory in its natural
//    (keys x Dh) layout with the B-transpose bit.  m, l and O stay in fp32
//    registers.
//  * Masks: key tiles wholly above the causal diagonal or outside the
//    window are never loaded (for the block) or never multiplied (for a
//    consumer whose 64 rows cannot see them); only tiles that straddle the
//    diagonal, the window's edge or Sk apply the element mask.  Query tiles
//    are issued heaviest (last) first so that the causal triangle balances.
//  * Output: each consumer writes its normalised 64 x Dh tile as bf16 into
//    its own (now free) rows of the Q buffer, in the swizzled layout, and
//    one thread stores it with TMA, which drops rows past Sq and columns
//    past Dh.
//  * D (64 / 128 / 256) is a template parameter.  D = 256 halves the key
//    tile to 64 rows (S in 32 registers beside O's 128); shared memory is
//    Q 16 / 32 / 64 KB plus 2 stages of K and V, 80 / 160 / 192 KB in all,
//    set with cudaFuncAttributeMaxDynamicSharedMemorySize.
//
// What holds it back (PERF.md, PR 14).  Each consumer runs S, softmax and
// P V of a tile in turn; the two consumers overlap each other, not their
// own phases.  ptxas allocates the consumer branch within the launch
// bound's 168 registers (setmaxnreg moves registers at run time, but the
// allocation did not use them), so D = 256 spills ~540 bytes.  Tried on
// the card and dropped: overlapping a tile's softmax with the P V before
// it (FA3's intra-warpgroup pipelining: S and P live at once, so it
// spilled and ran slower; with 64-key tiles it fit, but the smaller tiles
// lost more than the overlap won), and ping-pong named barriers between
// the two consumers (no spills and faster at D = 256, slower at D = 128,
// the main path's).
//
// Launch: on the caller's stream, no synchronisation, no allocation.
// Returns a cudaError_t as an int (cudaGetLastError() after the launch).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 128;              // query rows per block
constexpr int kThreads = 384;             // producer + 2 consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kStages = 2;                // K/V ring depth
constexpr int kBox = 64;                  // bf16 columns per TMA box (128 B)
constexpr int kRowBytes = kBox * 2;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int kChunks = D / kBox;            // boxes across Dh
  static constexpr int BN = D > 128 ? 64 : 128;       // key rows per tile
  static constexpr int Q_BYTES = kBlockM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;         // one K (or V) tile
  static constexpr int BAR_OFFSET = Q_BYTES + kStages * 2 * KV_BYTES;
  // + 1 KB to align the base to the swizzle atom, + the mbarriers
  static constexpr int SMEM_BYTES = BAR_OFFSET + 1024 + 64;
};

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- mbarriers ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Returns once the phase of parity `parity` has completed.  The spin is
// bounded: a pipeline fault traps (the launch fails) instead of hanging the
// card; a real wait is microseconds, the bound tens of milliseconds at
// least.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n == (1u << 22)) __trap();
  }
}

// ---- TMA ------------------------------------------------------------------

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---- wgmma ----------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units).  K-major tiles (Q, K): rows of
// 128 B, 8-row groups SBO = 1024 B apart, LBO unused (1).  V as an N-major
// B operand: 64-column boxes LBO apart, 8-key groups SBO = 1024 B apart.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
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

// Keeps the compiler from moving reads or writes of wgmma's registers
// across the (asynchronous) instruction's issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define WG_D32 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, " \
  "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31"
#define WG_D64 WG_D32 ", " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, " \
  "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, " \
  "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, " \
  "%62, %63"
#define WG_D128 WG_D64 ", " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, " \
  "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, " \
  "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, " \
  "%94, %95, %96, %97, %98, %99, %100, %101, %102, %103, " \
  "%104, %105, %106, %107, %108, %109, %110, %111, %112, %113, " \
  "%114, %115, %116, %117, %118, %119, %120, %121, %122, %123, " \
  "%124, %125, %126, %127"
#define WG_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_F16(i) WG_F4(i), WG_F4(i + 4), WG_F4(i + 8), WG_F4(i + 12)
#define WG_F32(i) WG_F16(i), WG_F16(i + 16)
#define WG_F64(i) WG_F32(i), WG_F32(i + 32)
#define WG_F128 WG_F64(0), WG_F64(64)

// m64nNk16, bf16 in, fp32 accumulate.  ss: d (+)= A B with A (64 x 16) and
// B (N x 16) K-major in shared memory; scale_d = 0 overwrites d.  rs:
// d += A B with A in registers and B (16 x N) N-major in shared memory.
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  __device__ static void ss(float (&d)[32], uint64_t da, uint64_t db,
                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_D32
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : WG_F32(0)
        : "l"(da), "l"(db), "r"(scale_d));
  }
  __device__ static void rs(float (&d)[32], const uint32_t (&a)[4],
                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_D32
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : WG_F32(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ static void ss(float (&d)[64], uint64_t da, uint64_t db,
                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_D64
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : WG_F64(0)
        : "l"(da), "l"(db), "r"(scale_d));
  }
  __device__ static void rs(float (&d)[64], const uint32_t (&a)[4],
                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_D64
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : WG_F64(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  __device__ static void rs(float (&d)[128], const uint32_t (&a)[4],
                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" WG_D128
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : WG_F128
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

// ---- the kernel -------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_o, int sq,
                       int sk, int hq, int group, int causal, int window,
                       int q_offset, float scale_log2) {
  using C = Cfg<D>;
  constexpr int BN = C::BN;
  constexpr int CH = C::kChunks;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t sQ = smem_u32(smem);               // CH x [128 rows][128 B]
  const uint32_t sKV = sQ + C::Q_BYTES;             // stage s: K then V
  const uint32_t bars = sQ + C::BAR_OFFSET;         // full, empty, Q
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  const uint32_t qbar = bars + 8 * 2 * kStages;

  const int b = blockIdx.x / hq;
  const int h = blockIdx.x % hq;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockM;  // heaviest first

  // the key tiles this query tile can see (positions: row + q_offset)
  const int q_last = min(q0 + kBlockM, sq) - 1 + q_offset;
  const int k_end = causal ? min(sk, q_last + 1) : sk;
  const int k_begin =
      (window > 0 ? max(0, q0 + q_offset - window + 1) : 0) / BN * BN;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BN - 1) / BN : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warp-uniform as the compiler sees it (measured a little faster)
  const int wg = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);
  if (wg == 0) {
    // ---- producer: one thread issues every TMA load -------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      const int hk = h / group;
      mbar_expect_tx(qbar, C::Q_BYTES);
      for (int c = 0; c < CH; ++c)
        tma_load(sQ + c * kBlockM * kRowBytes, &tm_q, qbar, c * kBox, h, q0,
                 b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * C::KV_BYTES);
        const int k0 = k_begin + it * BN;
        const uint32_t sK = sKV + s * 2 * C::KV_BYTES;
        const uint32_t sV = sK + C::KV_BYTES;
        for (int c = 0; c < CH; ++c) {
          tma_load(sK + c * BN * kRowBytes, &tm_k, full(s), c * kBox, hk, k0,
                   b);
          tma_load(sV + c * BN * kRowBytes, &tm_v, full(s), c * kBox, hk, k0,
                   b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ---------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;                  // accumulator row in 8
    const int t = lane % 4;                  // accumulator column pair
    const int r0 = q0 + 64 * cw;             // this warpgroup's first row
    const int p0 = r0 + q_offset;            // and its position
    const int row_a = p0 + warp * 16 + g;    // positions of d[4j], d[4j + 2]
    const uint32_t sQw = sQ + 64 * cw * kRowBytes;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m_row[2] = {neg_inf(), neg_inf()};  // running max, log2 units
    float l_row[2] = {0.f, 0.f};              // this thread's partial sums

    mbar_wait(qbar, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const int k0 = k_begin + it * BN;
      mbar_wait(full(s), (it / kStages) & 1);
      const bool sees = r0 < sq && (!causal || k0 <= p0 + 63) &&
                        (window == 0 || p0 - (k0 + BN - 1) < window);
      if (sees) {
        const uint32_t sK = sKV + s * 2 * C::KV_BYTES;
        const uint32_t sV = sK + C::KV_BYTES;

        // S = Q K^T (64 x BN)
        float sc[BN / 2];
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;   // 16 columns in the box
          Wgmma<BN>::ss(
              sc,
              make_desc(sQw + (kk / 4) * kBlockM * kRowBytes + off, 16, 1024),
              make_desc(sK + (kk / 4) * BN * kRowBytes + off, 16, 1024),
              kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        // mask the tiles that straddle the diagonal, the window or Sk
        if ((causal && k0 + BN - 1 > p0) ||
            (window > 0 && p0 + 63 - k0 >= window) || k0 + BN > sk) {
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) {
            const int row = row_a + 8 * ((i >> 1) & 1);
            const int col = k0 + 8 * (i / 4) + 2 * t + (i & 1);
            bool ok = col < sk;
            if (causal) ok = ok && row >= col;
            if (window > 0) ok = ok && row - col < window;
            if (!ok) sc[i] = neg_inf();
          }
        }

        // online softmax of rows row_a and row_a + 8 (base 2)
        float m_new[2] = {neg_inf(), neg_inf()};
#pragma unroll
        for (int i = 0; i < BN / 2; ++i)
          m_new[(i >> 1) & 1] = fmaxf(m_new[(i >> 1) & 1], sc[i]);
        float base[2], corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = m_new[r];
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 2));
          mx = fmaxf(m_row[r], mx * scale_log2);
          // a row with nothing to attend yet keeps a finite base:
          // exp2(-inf) = 0
          base[r] = mx == neg_inf() ? 0.f : mx;
          corr[r] = exp2f(m_row[r] - base[r]);
          m_row[r] = mx;
          l_row[r] *= corr[r];
        }
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int r = (i >> 1) & 1;
          sc[i] = exp2f(fmaf(sc[i], scale_log2, -base[r]));
          l_row[r] += sc[i];
        }
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];

        // P as wgmma A fragments: keys 16kk.. are n8 blocks 2kk, 2kk + 1
        uint32_t p[BN / 16][4];
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
          p[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
          p[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
          p[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
          p[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
        }

        // O += P V: V (BN keys x D) read N-major, 16 keys a step
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          Wgmma<D>::rs(acc, p[kk],
                       make_desc(sV + kk * 16 * kRowBytes, BN * kRowBytes,
                                 1024));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
        fence_regs(p);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }

    // finish: full row sums across the quad, normalise, and write bf16 into
    // this warpgroup's rows of the Q buffer (its wgmmas are done), swizzled
    // as the O tensor map expects; then one thread stores the tile
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_row[r] += __shfl_xor_sync(0xffffffff, l_row[r], 1);
      l_row[r] += __shfl_xor_sync(0xffffffff, l_row[r], 2);
    }
    const float inv[2] = {1.f / fmaxf(l_row[0], 1e-30f),
                          1.f / fmaxf(l_row[1], 1e-30f)};
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = warp * 16 + g + 8 * r;     // in the warpgroup's 64
        const uint32_t addr = sQw + (j / 8) * kBlockM * kRowBytes +
                              row * kRowBytes + (((j % 8) ^ g) * 16) + t * 4;
        const uint32_t val = pack_bf16(acc[4 * j + 2 * r] * inv[r],
                                       acc[4 * j + 2 * r + 1] * inv[r]);
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(val)
                     : "memory");
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
    if (tid == 0 && r0 < sq) {
      for (int c = 0; c < CH; ++c)
        tma_store(&tm_o, sQw + c * kBlockM * kRowBytes, c * kBox, h, r0, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

// ---- host side ----------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so the
// library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 (Dh, H, S, B) tensor map with boxes of 64 columns x `rows` rows of
// one head, 128-byte swizzle, zero fill out of bounds.
bool make_map(CUtensorMap* map, const void* ptr, const int64_t* dims,
              const int64_t* strides, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t gdim[4] = {(cuuint64_t)dims[0], (cuuint64_t)dims[1],
                              (cuuint64_t)dims[2], (cuuint64_t)dims[3]};
  const cuuint64_t gstride[3] = {(cuuint64_t)strides[0],
                                 (cuuint64_t)strides[1],
                                 (cuuint64_t)strides[2]};
  const cuuint32_t box[4] = {(cuuint32_t)kBox, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), gdim, gstride, box, estride,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out,
           const int64_t* qg, const int64_t* kg, int causal, int window,
           int q_offset, cudaStream_t stream) {
  using C = Cfg<D>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  CUtensorMap tq, tk, tv, to;
  if (!make_map(&tq, q, qg, qg + 4, kBlockM) ||
      !make_map(&tk, k, kg, kg + 4, C::BN) ||
      !make_map(&tv, v, kg, kg + 4, C::BN) ||
      !make_map(&to, out, qg, qg + 4, 64))
    return (int)cudaErrorInvalidValue;
  const int64_t dh = qg[0], hq = qg[1], sq = qg[2], b = qg[3];
  const int64_t hkv = kg[1], sk = kg[2];
  const dim3 grid((unsigned)(b * hq),
                  (unsigned)((sq + kBlockM - 1) / kBlockM));
  const float scale_log2 = kLog2e / sqrtf((float)dh);
  flash_attention_kernel<D><<<grid, kThreads, C::SMEM_BYTES, stream>>>(
      tq, tk, tv, to, (int)sq, (int)sk, (int)hq, (int)(hq / hkv), causal,
      window, q_offset, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// geom: the (Dh, H, S, B) dims and the byte strides of H, S and B, first of
// q (and out), then of k (and v): 14 int64.  q_offset: the position of
// query row 0 (0 <= q_offset, q_offset + Sq < 2^31).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out,
                                     const int64_t* geom, int64_t causal,
                                     int64_t window, int64_t q_offset,
                                     void* stream) {
  const int64_t* qg = geom;
  const int64_t* kg = geom + 7;
  const int64_t dh = qg[0], hq = qg[1], sq = qg[2], b = qg[3];
  const int64_t hkv = kg[1], sk = kg[2];
  bool ok = kg[0] == dh && kg[3] == b && b > 0 && sq > 0 && sk > 0 &&
            hkv > 0 && hq % hkv == 0 && dh > 0 && dh % 8 == 0 && dh <= 256 &&
            sq <= 0x7fffffff && sk <= 0x7fffffff &&
            (sq + kBlockM - 1) / kBlockM <= 65535 && b * hq <= 0x7fffffff &&
            window >= 0 && window <= 0x7fffffff && q_offset >= 0 &&
            q_offset + sq + kBlockM <= 0x7fffffff;
  for (int i = 4; i < 7; ++i)
    ok = ok && qg[i] % 16 == 0 && kg[i] % 16 == 0;
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int c = causal ? 1 : 0, w = (int)window, o = (int)q_offset;
  if (dh <= 64) return launch<64>(q, k, v, out, qg, kg, c, w, o, s);
  if (dh <= 128) return launch<128>(q, k, v, out, qg, kg, c, w, o, s);
  return launch<256>(q, k, v, out, qg, kg, c, w, o, s);
}
