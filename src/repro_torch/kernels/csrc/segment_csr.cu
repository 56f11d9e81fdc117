// Masked histogram: counts[v] = number of valid slots i with values[i] == v,
// for v in [0, num_segments); values outside that range are not counted.
// The CSR build's row counts and the in/out degrees of the analytics.
//
// Replaces the Pallas TPU kernel src/repro/kernels/segment_csr.py
// (_hist_kernel).  That kernel lowers the scatter-add as a one-hot
// (TILE x SEG_BLOCK) matmul on the MXU over a sequential 2-D grid that
// accumulates into each output block.  Hopper has native atomics and its
// blocks run in no order, so none of that carries over: one thread per
// value (grid-stride loop, 256 threads a block) adds 1 with atomicAdd into
// the int32 counts, which the wrapper zeroed on the stream.
//
// Bound.  5 bytes streamed per slot (int32 value + bool flag), 4 bytes per
// bin written, plus one 4-byte atomic per valid slot into the counts.  The
// analytics' counts (600k vertices x 4 B = 2.4 MB) stay in the 50 MB L2,
// so the atomics resolve there: the kernel is memory bound.  On Zipf-skewed
// values (TPC-DS i_sk, the hubs of a customer-item graph) many atomics hit
// one address and serialise in L2; that contention is the expected limit.
// Warp-aggregated atomics, or a shared-memory privatised histogram where
// the bins fit (num_segments * 4 <= 48 KB), are later work.
//
// Launch: on the caller's stream, no synchronisation, no allocation.  The
// wrapper handles n == 0 and num_segments == 0 without a launch.  Returns
// cudaGetLastError() as an int.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;

__global__ void segment_counts_kernel(const int32_t* __restrict__ values,
                                      const bool* __restrict__ valid,
                                      int64_t n, int64_t num_segments,
                                      int32_t* __restrict__ counts) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (!valid[i]) continue;
    const int32_t v = __ldg(values + i);
    if (v >= 0 && (int64_t)v < num_segments) atomicAdd(counts + v, 1);
  }
}

}  // namespace

extern "C" int repro_segment_counts(const void* values, const void* valid,
                                    void* counts, int64_t n,
                                    int64_t num_segments, void* stream) {
  if (n <= 0 || num_segments <= 0) return (int)cudaErrorInvalidValue;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  segment_counts_kernel<<<(unsigned)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const int32_t*)values, (const bool*)valid, n, num_segments,
      (int32_t*)counts);
  return (int)cudaGetLastError();
}
