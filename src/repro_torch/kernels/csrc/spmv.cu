// Push SpMV over COO edges: y[v] = sum of x[u] over valid edges (u -> v)
// with v in [0, n).  The inner loop of PageRank.
//
// Replaces the Pallas TPU kernel src/repro/kernels/spmv.py (_spmv_kernel).
// That kernel gathers x from VMEM and lowers the scatter-add as a scaled
// one-hot (TILE x SEG_BLOCK) matmul on the MXU, accumulating over a
// sequential 2-D grid.  On Hopper the scatter is atomic, and what bounds it
// is where the atomics land: on the JS-OJ graph one item hub receives 18%
// of the edges, and one float32 atomicAdd per edge would serialise ~515k
// of them on one L2 address.
//
// Design: block-private aggregation in shared memory.
//   * Persistent blocks (a few per SM; the wrapper's _build.scatter_grid):
//     each takes a contiguous range of whole tiles of kTileEdges edges.
//     A thread loads 4 edges at once: src and dst as one 16-byte load
//     each, valid as one 4-byte word (scalar loads when the operands are
//     not so aligned, and at the range's ragged end).
//   * A warp step: lanes whose edges share a destination find each other
//     with __match_any_sync and sum their x[src] in a shuffle tree, so one
//     lane per destination goes on.  Hopper has no float atomicAdd in
//     shared memory (it compiles to a compare-and-swap loop), so a hub's
//     lanes would otherwise retry on one slot.
//   * A table in shared memory, kSlots slots of (int32 key = dst, float
//     partial sum), empty key -1, multiplicative hash and linear probing.
//     The lane claims or finds its slot (atomicCAS on the key, at most
//     kMaxProbe slots) and adds its sum with a shared atomicAdd.  A lane
//     whose probe finds no slot adds straight into y with a global atomic:
//     part of the algorithm, so the table never has to fit.
//   * After each tile (__syncthreads), every occupied slot is flushed into
//     y with one global atomicAdd and emptied.  A tile holds at most half
//     as many edges as the table has slots, so probes stay short; a hub
//     costs one global atomic per tile instead of one per edge.
// On a graph without hubs (random destinations) every slot is flushed and
// the kernel does what one atomic per edge did; what bounds it then is the
// rate of the L2's atomics.
// src is clipped into [0, len(x)) before the gather, as the Pallas kernel
// clips it.
//
// Exactness.  The float32 sums are taken in an order that changes from run
// to run (shuffle sums in a warp, shared atomics inside a tile, then
// global atomics of the partial sums).  Whatever the summation tree, its
// depth is below deg_in(v), so per vertex the error against an exact sum
// stays within the recursive-summation bound
// deg_in(v) * 2^-24 * sum |x[u]|; the tests and chip_smoke.py hold it to
// twice that.
//
// Bound.  9 bytes streamed per edge (src, dst, valid) and 4 bytes per
// vertex of x read and y written; the gather of x and the global atomics
// stay in the 50 MB L2 (x and y: 2.4 MB each at 600k vertices).  Left for
// later: a pull over dst-sorted edges (a segmented sum, deterministic
// too), which needs a cached transposed order in the CSR.
//
// Launch: on the caller's stream, no synchronisation, no allocation.  The
// wrapper handles an empty edge list or vertex set without a launch.
// Returns cudaGetLastError() (or cudaErrorInvalidValue for a grid that
// does not cover the edges in whole tiles) as an int.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kVec = 4;                          // edges per thread a tile
constexpr int64_t kTileEdges = kThreads * kVec;  // 2,048
constexpr int kSlotBits = 12;
constexpr int kSlots = 1 << kSlotBits;           // 4,096: 32 KB of table
constexpr int kMaxProbe = 16;
constexpr int32_t kEmpty = -1;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned home_slot(int32_t d) {
  return ((uint32_t)d * 2654435769u) >> (32 - kSlotBits);
}

// Add v to key d's slot; false when no slot within kMaxProbe is d's.
__device__ __forceinline__ bool table_add(int32_t* keys, float* vals,
                                          int32_t d, float v) {
  const volatile int32_t* vkeys = keys;
  unsigned slot = home_slot(d);
  for (int p = 0; p < kMaxProbe; ++p, slot = (slot + 1) & (kSlots - 1)) {
    int32_t k = vkeys[slot];
    if (k == kEmpty) k = atomicCAS(keys + slot, kEmpty, d);
    if (k == kEmpty || k == d) {
      atomicAdd(vals + slot, v);
      return true;
    }
  }
  return false;
}

// Sum v over each group of lanes with equal keys (peers, from
// __match_any_sync): a tree in ceil(log2(group)) shuffle rounds, after
// which the group's lowest lane holds the sum.  All 32 lanes call it.
__device__ __forceinline__ float peer_sum(unsigned peers, float v) {
  const unsigned lane = threadIdx.x & 31u;
  unsigned rank = __popc(peers & ((1u << lane) - 1u));  // peers below
  unsigned above = peers & ~((2u << lane) - 1u);          // peers above
  while (__any_sync(kFull, above != 0u)) {
    const int next = __ffs(above);
    const float t = __shfl_sync(kFull, v, next ? next - 1 : (int)lane);
    if (next) v += t;
    // a lane of odd rank has been added to the one below it: drop it
    above &= __ballot_sync(kFull, (rank & 1u) == 0u);
    rank >>= 1;
  }
  return v;
}

// One edge a lane; all 32 lanes of the warp call it together.
__device__ __forceinline__ void push_edge(int32_t s, int32_t d, bool ok,
                                          const float* __restrict__ x,
                                          int64_t nx, int64_t n,
                                          float* __restrict__ y,
                                          int32_t* keys, float* vals) {
  const unsigned lane = threadIdx.x & 31u;
  const bool keep = ok && d >= 0 && (int64_t)d < n;
  float v = 0.f;
  if (keep) v = __ldg(x + (s < 0 ? 0 : ((int64_t)s >= nx ? nx - 1 : s)));
  // equal destinations in the warp merge first; a dropped lane matches
  // none (its key is negative and its own)
  const unsigned peers =
      __match_any_sync(kFull, keep ? d : -1 - (int32_t)lane);
  v = peer_sum(peers, v);
  if (keep && lane == (unsigned)(__ffs(peers) - 1) &&
      !table_add(keys, vals, d, v))
    atomicAdd(y + d, v);
}

template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
edge_spmv_kernel(const int32_t* __restrict__ src,
                 const int32_t* __restrict__ dst,
                 const bool* __restrict__ valid,
                 const float* __restrict__ x, int64_t nx, int64_t n_edges,
                 int64_t n, int64_t edges_per_block, float* __restrict__ y) {
  __shared__ int32_t keys[kSlots];
  __shared__ float vals[kSlots];
  for (int i = threadIdx.x; i < kSlots; i += kThreads) {
    keys[i] = kEmpty;
    vals[i] = 0.f;
  }
  const int64_t begin = (int64_t)blockIdx.x * edges_per_block;
  const int64_t end = begin + edges_per_block < n_edges
                            ? begin + edges_per_block
                            : n_edges;
  for (int64_t tile = begin; tile < end; tile += kTileEdges) {
    __syncthreads();                      // the table is empty
    const int64_t e = tile + (int64_t)threadIdx.x * kVec;
    int32_t s[kVec], d[kVec];
    bool ok[kVec];
    if (kAligned && e + kVec <= end) {
      const int4 s4 = __ldg(reinterpret_cast<const int4*>(src + e));
      const int4 d4 = __ldg(reinterpret_cast<const int4*>(dst + e));
      const uint32_t v4 =
          __ldg(reinterpret_cast<const unsigned int*>(valid + e));
      s[0] = s4.x, s[1] = s4.y, s[2] = s4.z, s[3] = s4.w;
      d[0] = d4.x, d[1] = d4.y, d[2] = d4.z, d[3] = d4.w;
#pragma unroll
      for (int k = 0; k < kVec; ++k) ok[k] = (v4 >> (8 * k)) & 0xffu;
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        ok[k] = e + k < end && valid[e + k];
        s[k] = ok[k] ? __ldg(src + e + k) : 0;
        d[k] = ok[k] ? __ldg(dst + e + k) : -1;
      }
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      push_edge(s[k], d[k], ok[k], x, nx, n, y, keys, vals);
    __syncthreads();                      // the tile is in the table
    for (int i = threadIdx.x; i < kSlots; i += kThreads) {
      const int32_t k = keys[i];
      if (k != kEmpty) {
        atomicAdd(y + k, vals[i]);
        keys[i] = kEmpty;
        vals[i] = 0.f;
      }
    }
  }
}

}  // namespace

extern "C" int repro_edge_spmv(const void* src, const void* dst,
                               const void* valid, const void* x, void* y,
                               int64_t n_edges, int64_t nx, int64_t n,
                               int64_t blocks, int64_t edges_per_block,
                               void* stream) {
  if (n_edges <= 0 || nx <= 0 || n <= 0 || blocks <= 0 ||
      edges_per_block <= 0 || edges_per_block % kTileEdges != 0 ||
      blocks * edges_per_block < n_edges ||
      (blocks - 1) * edges_per_block >= n_edges || blocks > (1ll << 31) - 1)
    return (int)cudaErrorInvalidValue;
  const bool aligned = (uintptr_t)src % 16 == 0 && (uintptr_t)dst % 16 == 0 &&
                       (uintptr_t)valid % 4 == 0;
  auto kernel = aligned ? &edge_spmv_kernel<true> : &edge_spmv_kernel<false>;
  kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)src, (const int32_t*)dst, (const bool*)valid,
      (const float*)x, nx, n_edges, n, edges_per_block, (float*)y);
  return (int)cudaGetLastError();
}
