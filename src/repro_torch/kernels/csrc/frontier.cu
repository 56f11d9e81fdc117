// One BFS level over COO edges:
//   out[v] = (some valid edge (u -> v) has frontier[u]) and not visited[v]
// for v in [0, n).  The inner loop of k-hop.
//
// Replaces the Pallas TPU kernel src/repro/kernels/frontier.py
// (_frontier_kernel).  That kernel counts reaching edges with a one-hot
// (TILE x SEG_BLOCK) matmul on the MXU over a sequential 2-D grid and
// applies ~visited on the last edge tile.  On Hopper no count is needed:
// the wrapper zeroes the bool output, then one thread per edge (grid-stride
// loop, 256 threads a block) with frontier[src] set and visited[dst] clear
// stores 1 into out[dst].  Every writer stores the same byte, so the stores
// need no atomic and the result is exact.  src is clipped into
// [0, len(frontier)), as the Pallas kernel clips it.
//
// Bound.  9 bytes streamed per edge (src, dst, valid), a random 1-byte
// gather of frontier per valid edge and of visited per frontier edge, a
// 1-byte store per reaching edge, n bytes written by the zeroing.  The
// vertex masks (600k x 1 B) stay in L2: memory bound.  Stores to one hub
// land on one line; with few frontier vertices most threads only stream
// their edge, so the kernel runs near the streaming rate.  Skipping the
// store when out[dst] is already set, or a sparse frontier (expanding only
// the frontier's CSR rows), are later work.
//
// Launch: on the caller's stream, no synchronisation, no allocation.  The
// wrapper handles an empty edge list or vertex set without a launch.
// Returns cudaGetLastError() as an int.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;

__global__ void frontier_expand_kernel(const int32_t* __restrict__ src,
                                       const int32_t* __restrict__ dst,
                                       const bool* __restrict__ valid,
                                       const bool* __restrict__ frontier,
                                       int64_t n_frontier,
                                       const bool* __restrict__ visited,
                                       int64_t n_edges, int64_t n,
                                       bool* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_edges; i += stride) {
    if (!valid[i]) continue;
    const int32_t d = __ldg(dst + i);
    if (d < 0 || (int64_t)d >= n) continue;
    int64_t s = __ldg(src + i);
    s = s < 0 ? 0 : (s >= n_frontier ? n_frontier - 1 : s);
    if (frontier[s] && !visited[d]) out[d] = true;
  }
}

}  // namespace

extern "C" int repro_frontier_expand(const void* src, const void* dst,
                                     const void* valid, const void* frontier,
                                     const void* visited, void* out,
                                     int64_t n_edges, int64_t n_frontier,
                                     int64_t n, void* stream) {
  if (n_edges <= 0 || n_frontier <= 0 || n <= 0)
    return (int)cudaErrorInvalidValue;
  int64_t blocks = (n_edges + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  frontier_expand_kernel<<<(unsigned)blocks, kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const int32_t*)src, (const int32_t*)dst, (const bool*)valid,
      (const bool*)frontier, n_frontier, (const bool*)visited, n_edges, n,
      (bool*)out);
  return (int)cudaGetLastError();
}
