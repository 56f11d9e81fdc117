// One min-label propagation step over COO edges:
//   out[v] = min(labels[v], min of labels[u] over valid edges (u -> v))
// for v in [0, n).  The inner loop of weakly connected components.
//
// Replaces the Pallas TPU kernel src/repro/kernels/label_prop.py
// (_minlabel_kernel).  That kernel builds a (TILE x SEG_BLOCK) membership
// mask per edge tile and min-reduces it on the VPU over a sequential 2-D
// grid.  On Hopper the scatter-min is an atomic: the wrapper starts the
// output as a copy of labels[:n] (the vertex's own label, so isolated
// vertices keep theirs), then one thread per edge (grid-stride loop, 256
// threads a block) gathers labels[src] and applies atomicMin to out[dst].
// The gather reads the input labels, never out, so the step is the same
// Jacobi step as the reference, whatever order the atomics land in: the
// result is exact.  src is clipped into [0, len(labels)), as the Pallas
// kernel clips it.
//
// Bound.  9 bytes streamed per edge (src, dst, valid), a random 4-byte
// gather and a 4-byte atomicMin per valid edge, 4 bytes per vertex read and
// written for the copy.  The label arrays (600k vertices x 4 B = 2.4 MB)
// stay in the 50 MB L2: memory bound.  Zipf hubs send many atomics to one
// address, where they serialise in L2: the expected limit.  Skipping the
// atomic when the gathered label is not below out[dst], warp-aggregated
// atomics, or a pull over dst-sorted edges are later work.
//
// Launch: on the caller's stream, no synchronisation, no allocation.  The
// wrapper handles an empty edge list or vertex set without a launch.
// Returns cudaGetLastError() as an int.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;

__global__ void edge_min_label_kernel(const int32_t* __restrict__ src,
                                      const int32_t* __restrict__ dst,
                                      const bool* __restrict__ valid,
                                      const int32_t* __restrict__ labels,
                                      int64_t n_labels, int64_t n_edges,
                                      int64_t n, int32_t* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_edges; i += stride) {
    if (!valid[i]) continue;
    const int32_t d = __ldg(dst + i);
    if (d < 0 || (int64_t)d >= n) continue;
    int64_t s = __ldg(src + i);
    s = s < 0 ? 0 : (s >= n_labels ? n_labels - 1 : s);
    atomicMin(out + d, __ldg(labels + s));
  }
}

}  // namespace

extern "C" int repro_edge_min_label(const void* src, const void* dst,
                                    const void* valid, const void* labels,
                                    void* out, int64_t n_edges,
                                    int64_t n_labels, int64_t n,
                                    void* stream) {
  if (n_edges <= 0 || n_labels <= 0 || n <= 0)
    return (int)cudaErrorInvalidValue;
  int64_t blocks = (n_edges + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  edge_min_label_kernel<<<(unsigned)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const int32_t*)src, (const int32_t*)dst, (const bool*)valid,
      (const int32_t*)labels, n_labels, n_edges, n, (int32_t*)out);
  return (int)cudaGetLastError();
}
