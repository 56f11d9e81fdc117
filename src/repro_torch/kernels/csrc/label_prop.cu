// One min-label propagation step over COO edges:
//   out[v] = min(labels[v], min of labels[u] over valid edges (u -> v))
// for v in [0, n).  The inner loop of weakly connected components.
//
// Replaces the Pallas TPU kernel src/repro/kernels/label_prop.py
// (_minlabel_kernel).  That kernel builds a (TILE x SEG_BLOCK) membership
// mask per edge tile and min-reduces it on the VPU over a sequential 2-D
// grid.  On Hopper the scatter-min is atomic, and what bounds it is where
// the atomics land: the JS-OJ graph's item hubs receive hundreds of
// thousands of edges each, and one atomicMin per edge would serialise them
// on one L2 address each.
//
// The wrapper starts the output as a copy of labels[:n] (the vertex's own
// label, so isolated vertices keep theirs).  Then, the same design as
// csrc/spmv.cu:
//   * Persistent blocks (_build.scatter_grid), each over a contiguous range
//     of whole tiles of kTileEdges edges; src and dst in 16-byte loads,
//     valid in 4-byte words (scalar loads when not so aligned).
//   * Skip-if-not-smaller: an edge whose label labels[u] is not below the
//     current out[v] does nothing.  out only decreases from labels[:n], so
//     any value read, stale or not, is an upper bound of the final one and
//     the skip is exact.  out is written by this kernel, so it is read with
//     __ldcg (L2), never __ldg / ld.global.nc.  In WCC's later steps most
//     labels have converged and nearly every edge stops here.
//   * A table in shared memory, kSlots slots of (int32 key = dst, int32
//     running minimum), empty key -1, multiplicative hash and linear
//     probing: a remaining edge claims or finds its slot (atomicCAS on the
//     key, at most kMaxProbe slots) and applies a shared atomicMin when it
//     lowers the slot.  An edge whose probe finds no slot applies atomicMin
//     to out directly: part of the algorithm.
//   * After each tile (__syncthreads), every occupied slot whose minimum is
//     below out[key] is flushed with one global atomicMin, and emptied.  A
//     hub costs one global atomic per tile instead of one per edge.
// spmv.cu's warp step (__match_any_sync before the table) is left out:
// atomicMin is native in shared memory, and on the H100 the step saved
// little on WCC's first step and cost more than that in its later steps,
// where nearly every edge is skipped before it, and on the JS-MV graph.
// The gather reads the input labels, never out, so the step is the same
// Jacobi step as the reference, whatever order the atomics land in: the
// result is exact.  src is clipped into [0, len(labels)), as the Pallas
// kernel clips it.
//
// Bound.  9 bytes streamed per edge (src, dst, valid), 4 bytes per vertex
// read and written for the copy; the gathers of labels and out and the
// atomics stay in the 50 MB L2 (2.4 MB of labels at 600k vertices).
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
constexpr int32_t kNone = 2147483647;            // an empty slot's minimum

__device__ __forceinline__ unsigned home_slot(int32_t d) {
  return ((uint32_t)d * 2654435769u) >> (32 - kSlotBits);
}

// Lower key d's slot to l; false when no slot within kMaxProbe is d's.
__device__ __forceinline__ bool table_min(int32_t* keys, int32_t* vals,
                                          int32_t d, int32_t l) {
  const volatile int32_t* vkeys = keys;
  const volatile int32_t* vvals = vals;
  unsigned slot = home_slot(d);
  for (int p = 0; p < kMaxProbe; ++p, slot = (slot + 1) & (kSlots - 1)) {
    int32_t k = vkeys[slot];
    if (k == kEmpty) k = atomicCAS(keys + slot, kEmpty, d);
    if (k == kEmpty || k == d) {
      if (l < vvals[slot]) atomicMin(vals + slot, l);
      return true;
    }
  }
  return false;
}

__device__ __forceinline__ void min_edge(int32_t s, int32_t d, bool ok,
                                         const int32_t* __restrict__ labels,
                                         int64_t n_labels, int64_t n,
                                         int32_t* __restrict__ out,
                                         int32_t* keys, int32_t* vals) {
  if (!ok || d < 0 || (int64_t)d >= n) return;
  const int64_t si = s < 0 ? 0 : ((int64_t)s >= n_labels ? n_labels - 1 : s);
  const int32_t l = __ldg(labels + si);
  if (l >= __ldcg(out + d)) return;       // cannot lower out[d]
  if (!table_min(keys, vals, d, l)) atomicMin(out + d, l);
}

template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
edge_min_label_kernel(const int32_t* __restrict__ src,
                      const int32_t* __restrict__ dst,
                      const bool* __restrict__ valid,
                      const int32_t* __restrict__ labels, int64_t n_labels,
                      int64_t n_edges, int64_t n, int64_t edges_per_block,
                      int32_t* __restrict__ out) {
  __shared__ int32_t keys[kSlots];
  __shared__ int32_t vals[kSlots];
  for (int i = threadIdx.x; i < kSlots; i += kThreads) {
    keys[i] = kEmpty;
    vals[i] = kNone;
  }
  const int64_t begin = (int64_t)blockIdx.x * edges_per_block;
  const int64_t end = begin + edges_per_block < n_edges
                            ? begin + edges_per_block
                            : n_edges;
  for (int64_t tile = begin; tile < end; tile += kTileEdges) {
    __syncthreads();                      // the table is empty
    const int64_t e = tile + (int64_t)threadIdx.x * kVec;
    if (kAligned && e + kVec <= end) {
      const int4 s4 = __ldg(reinterpret_cast<const int4*>(src + e));
      const int4 d4 = __ldg(reinterpret_cast<const int4*>(dst + e));
      const uint32_t v4 =
          __ldg(reinterpret_cast<const unsigned int*>(valid + e));
      min_edge(s4.x, d4.x, v4 & 0xffu, labels, n_labels, n, out, keys, vals);
      min_edge(s4.y, d4.y, (v4 >> 8) & 0xffu, labels, n_labels, n, out, keys,
               vals);
      min_edge(s4.z, d4.z, (v4 >> 16) & 0xffu, labels, n_labels, n, out,
               keys, vals);
      min_edge(s4.w, d4.w, v4 >> 24, labels, n_labels, n, out, keys, vals);
    } else {
      for (int k = 0; k < kVec && e + k < end; ++k)
        min_edge(__ldg(src + e + k), __ldg(dst + e + k), valid[e + k],
                 labels, n_labels, n, out, keys, vals);
    }
    __syncthreads();                      // the tile is in the table
    for (int i = threadIdx.x; i < kSlots; i += kThreads) {
      const int32_t k = keys[i];
      if (k != kEmpty) {
        const int32_t v = vals[i];
        if (v < __ldcg(out + k)) atomicMin(out + k, v);
        keys[i] = kEmpty;
        vals[i] = kNone;
      }
    }
  }
}

}  // namespace

extern "C" int repro_edge_min_label(const void* src, const void* dst,
                                    const void* valid, const void* labels,
                                    void* out, int64_t n_edges,
                                    int64_t n_labels, int64_t n,
                                    int64_t blocks, int64_t edges_per_block,
                                    void* stream) {
  if (n_edges <= 0 || n_labels <= 0 || n <= 0 || blocks <= 0 ||
      edges_per_block <= 0 || edges_per_block % kTileEdges != 0 ||
      blocks * edges_per_block < n_edges ||
      (blocks - 1) * edges_per_block >= n_edges || blocks > (1ll << 31) - 1)
    return (int)cudaErrorInvalidValue;
  const bool aligned = (uintptr_t)src % 16 == 0 && (uintptr_t)dst % 16 == 0 &&
                       (uintptr_t)valid % 4 == 0;
  auto kernel =
      aligned ? &edge_min_label_kernel<true> : &edge_min_label_kernel<false>;
  kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)src, (const int32_t*)dst, (const bool*)valid,
      (const int32_t*)labels, n_labels, n_edges, n, edges_per_block,
      (int32_t*)out);
  return (int)cudaGetLastError();
}
