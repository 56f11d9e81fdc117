// One BFS level over COO edges:
//   out[v] = (some valid edge (u -> v) has frontier[u]) and not visited[v]
// for v in [0, n).  The inner loop of k-hop.  The bool masks are read and
// written as bytes (uint8_t), which is what __ldg and __ldcg take.
//
// Replaces the Pallas TPU kernel src/repro/kernels/frontier.py
// (_frontier_kernel).  That kernel counts reaching edges with a one-hot
// (TILE x SEG_BLOCK) matmul on the MXU over a sequential 2-D grid and
// applies ~visited on the last edge tile.  On Hopper no count is needed:
// every writer stores the same byte, so the stores need no atomic and the
// result is exact.  src is clipped into [0, len(frontier)), as the Pallas
// kernel clips it; a dst outside [0, n) is dropped.
//
// What bounds it is the edge stream, and most of it is not needed: a
// frontier (8 seeds in k-hop's first level) is a small share of the
// vertices, so most valid edges leave from outside it.
//   * Persistent blocks (the block count of the wrapper's
//     _build.scatter_grid, no more than there are tiles) over strided tiles
//     of kTileEdges edges (block b the tiles b, b + blocks, ...), as
//     csrc/segment_csr.cu runs.
//   * A thread takes 4 edges: one 4-byte load of their valid flags; only
//     where one flag is on, one 16-byte load of their sources and the
//     frontier gathers; only where one source is in the frontier, one
//     16-byte load of their destinations.  Scalar loads for unaligned
//     views and at the ragged end.
//   * Test before set: an edge that reaches d reads visited[d], then
//     out[d] with __ldcg (never __ldg: the kernel writes out, and the
//     non-coherent cache is not kept in step with those writes), and
//     stores 1 only when the byte is 0.  Bytes only go from 0 to 1, so a
//     stale read costs one redundant store, never a wrong byte; on the item
//     hubs (in-degree up to 514,800) the stores no longer pile onto one
//     line.
//
// Bound.  The bytes any kernel must read for the operand at hand: a flag
// per edge, a source per valid edge, a destination per valid edge whose
// source is in the frontier, and the n bytes of the zero fill.  The
// vertex masks (600k x 1 B on the JS-OJ graph) stay in L2.
//
// Launch: on the caller's stream, no synchronisation, no allocation.  The
// wrapper zeroes out (a separate fill: a grid-wide zero before the writes
// would need a second launch either way) and handles an empty edge list or
// vertex set without a launch.  Returns cudaGetLastError() (or
// cudaErrorInvalidValue for a grid with no block or more blocks than
// tiles) as an int.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kVec = 4;                           // edges per thread a tile
constexpr int64_t kTileEdges = kThreads * kVec;   // 2,048

__device__ __forceinline__ int64_t clip(int32_t s, int64_t n_frontier) {
  return s < 0 ? 0 : (s >= n_frontier ? n_frontier - 1 : (int64_t)s);
}

// An edge from the frontier reaches d: set out[d] unless d is out of
// range, visited, or already set.
__device__ __forceinline__ void reach(int32_t d, int64_t n,
                                      const uint8_t* __restrict__ visited,
                                      uint8_t* __restrict__ out) {
  if (d < 0 || (int64_t)d >= n) return;
  if (__ldg(visited + d)) return;
  if (__ldcg(out + d)) return;
  out[d] = 1;
}

template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
frontier_expand_kernel(const int32_t* __restrict__ src,
                       const int32_t* __restrict__ dst,
                       const bool* __restrict__ valid,
                       const uint8_t* __restrict__ frontier,
                       int64_t n_frontier, const uint8_t* __restrict__ visited,
                       int64_t n_edges, int64_t n, uint8_t* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * kTileEdges;
  for (int64_t tile = (int64_t)blockIdx.x * kTileEdges; tile < n_edges;
       tile += stride) {
    const int64_t e = tile + (int64_t)threadIdx.x * kVec;
    if (kAligned && e + kVec <= n_edges) {
      const uint32_t f4 =
          __ldg(reinterpret_cast<const unsigned int*>(valid + e));
      if (!f4) continue;
      const int4 s4 = __ldg(reinterpret_cast<const int4*>(src + e));
      const int32_t s[kVec] = {s4.x, s4.y, s4.z, s4.w};
      bool hit[kVec];
      bool any = false;
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        hit[k] = ((f4 >> (8 * k)) & 0xffu) &&
                 __ldg(frontier + clip(s[k], n_frontier));
        any |= hit[k];
      }
      if (!any) continue;
      const int4 d4 = __ldg(reinterpret_cast<const int4*>(dst + e));
      const int32_t d[kVec] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        if (hit[k]) reach(d[k], n, visited, out);
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        if (e + k >= n_edges || !valid[e + k]) continue;
        if (__ldg(frontier + clip(__ldg(src + e + k), n_frontier)))
          reach(__ldg(dst + e + k), n, visited, out);
      }
    }
  }
}

}  // namespace

// blocks: the wrapper's _build.scatter_grid block count; strided tiles
// cover any grid, and the entry refuses one with a block and no tile.
extern "C" int repro_frontier_expand(const void* src, const void* dst,
                                     const void* valid, const void* frontier,
                                     const void* visited, void* out,
                                     int64_t n_edges, int64_t n_frontier,
                                     int64_t n, int64_t blocks,
                                     void* stream) {
  if (n_edges <= 0 || n_frontier <= 0 || n <= 0 || blocks <= 0 ||
      blocks > (n_edges + kTileEdges - 1) / kTileEdges ||
      blocks > (1ll << 31) - 1)
    return (int)cudaErrorInvalidValue;
  const bool aligned = (uintptr_t)src % 16 == 0 &&
                       (uintptr_t)dst % 16 == 0 && (uintptr_t)valid % 4 == 0;
  auto kernel = aligned ? &frontier_expand_kernel<true>
                        : &frontier_expand_kernel<false>;
  kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)src, (const int32_t*)dst, (const bool*)valid,
      (const uint8_t*)frontier, n_frontier, (const uint8_t*)visited, n_edges,
      n, (uint8_t*)out);
  return (int)cudaGetLastError();
}
