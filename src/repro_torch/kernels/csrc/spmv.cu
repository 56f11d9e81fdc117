// Push SpMV over COO edges: y[v] = sum of x[u] over valid edges (u -> v)
// with v in [0, n).  The inner loop of PageRank.
//
// Replaces the Pallas TPU kernel src/repro/kernels/spmv.py (_spmv_kernel).
// That kernel gathers x from VMEM and lowers the scatter-add as a scaled
// one-hot (TILE x SEG_BLOCK) matmul on the MXU, accumulating over a
// sequential 2-D grid.  On Hopper the scatter is an atomic: one thread per
// edge (grid-stride loop, 256 threads a block) gathers x[src] and adds it
// with a float32 atomicAdd into y, which the wrapper zeroed on the stream.
// src is clipped into [0, len(x)) before the gather, as the Pallas kernel
// clips it.
//
// Exactness.  The float32 sums are taken in the order the atomics land,
// which changes from run to run.  Per vertex the error against an exact
// sum is within the recursive-summation bound
// deg_in(v) * 2^-24 * sum |x[u]|; the tests and chip_smoke.py hold it to
// twice that.
//
// Bound.  9 bytes streamed per edge (src, dst, valid), a random 4-byte
// gather of x and a 4-byte atomic into y per valid edge, and 4 bytes per
// vertex of x read and y written.  x and y (600k vertices x 4 B = 2.4 MB
// each) stay in the 50 MB L2, so the kernel is memory bound.  Zipf hubs
// (TPC-DS i_sk) send many atomics to one address, where they serialise in
// L2: the expected limit.  Warp-aggregated atomics, or a pull over
// dst-sorted edges (a segmented sum, deterministic too), are later work.
//
// Launch: on the caller's stream, no synchronisation, no allocation.  The
// wrapper handles an empty edge list or vertex set without a launch.
// Returns cudaGetLastError() as an int.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;

__global__ void edge_spmv_kernel(const int32_t* __restrict__ src,
                                 const int32_t* __restrict__ dst,
                                 const bool* __restrict__ valid,
                                 const float* __restrict__ x, int64_t nx,
                                 int64_t n_edges, int64_t n,
                                 float* __restrict__ y) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_edges; i += stride) {
    if (!valid[i]) continue;
    const int32_t d = __ldg(dst + i);
    if (d < 0 || (int64_t)d >= n) continue;
    int64_t s = __ldg(src + i);
    s = s < 0 ? 0 : (s >= nx ? nx - 1 : s);
    atomicAdd(y + d, __ldg(x + s));
  }
}

}  // namespace

extern "C" int repro_edge_spmv(const void* src, const void* dst,
                               const void* valid, const void* x, void* y,
                               int64_t n_edges, int64_t nx, int64_t n,
                               void* stream) {
  if (n_edges <= 0 || nx <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  int64_t blocks = (n_edges + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  edge_spmv_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)src, (const int32_t*)dst, (const bool*)valid,
      (const float*)x, nx, n_edges, n, (float*)y);
  return (int)cudaGetLastError();
}
