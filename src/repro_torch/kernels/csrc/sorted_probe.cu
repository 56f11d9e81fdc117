// Join probe: (lo, hi) match range of every probe key in the sorted build keys.
//
// Replaces the Pallas TPU kernel src/repro/kernels/sorted_probe.py
// (_probe_kernel / _bisect): lo is the left bisection (first slot with
// sorted[j] >= key), hi the right one (first slot with sorted[j] > key),
// both int32, exactly as jnp.searchsorted(side="left"/"right").
//
// Design.  One thread per probe key, in a grid-stride loop, runs the left
// bisection over the whole build side in global memory, then the right
// bisection over [lo, S) (hi >= lo).  Unlike the Pallas version there is no
// limit on the build size: that one copies the whole build side into VMEM.
// Every search starts at the same midpoints, so the first levels hit the
// same few lines and stay in L1/L2; the main path's build sides (a 400 KB
// item key column, an 11.5 MB store_sales one) fit in the 50 MB L2
// entirely.  Two variants measured no better on the card (PERF.md): an
// equal-range search (fewer loads, but threads of a warp diverge on skewed
// keys: 4x slower) and both bisections in lockstep (two loads in flight:
// faster on a large build side, slower on a small one).
//
// Bound.  At least 4P bytes read and 8P written for P probe keys (plus the
// 4S build bytes once), and 2*(ceil(log2 S)+1) dependent loads per key:
// the kernel is bound by the latency of those loads, not by DRAM
// bandwidth.  Many threads in flight hide part of it; a shared-memory
// fence level for the first levels is the next step.
//
// Launch: on the caller's stream, no synchronisation, no allocation.  The
// wrapper handles P == 0 and S == 0 without a launch (a grid of 0 blocks is
// a launch error).  Returns cudaGetLastError() as an int.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// First slot in [lo, hi) with a[slot] >= key (or > key when kUpper).
template <bool kUpper>
__device__ __forceinline__ int64_t bisect(const int32_t* __restrict__ a,
                                          int64_t lo, int64_t hi,
                                          int32_t key) {
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    const int32_t v = __ldg(a + mid);
    if (kUpper ? v <= key : v < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void sorted_probe_kernel(const int32_t* __restrict__ sorted,
                                    int64_t n_sorted,
                                    const int32_t* __restrict__ probe,
                                    int64_t n_probe,
                                    int32_t* __restrict__ lo_out,
                                    int32_t* __restrict__ hi_out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_probe; i += stride) {
    const int32_t key = __ldg(probe + i);
    const int64_t lo = bisect<false>(sorted, 0, n_sorted, key);
    const int64_t hi = bisect<true>(sorted, lo, n_sorted, key);   // hi >= lo
    lo_out[i] = (int32_t)lo;
    hi_out[i] = (int32_t)hi;
  }
}

constexpr int kThreads = 256;
// 132 SMs x 8 resident 256-thread blocks, twice; the grid-stride loop
// covers larger inputs
constexpr int64_t kMaxBlocks = 132 * 16;

}  // namespace

extern "C" int repro_sorted_probe(const void* sorted, const void* probe,
                                  void* lo, void* hi, int64_t n_sorted,
                                  int64_t n_probe, void* stream) {
  if (n_probe <= 0 || n_sorted <= 0) return (int)cudaErrorInvalidValue;
  int64_t blocks = (n_probe + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  sorted_probe_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const int32_t*)sorted, n_sorted, (const int32_t*)probe, n_probe,
      (int32_t*)lo, (int32_t*)hi);
  return (int)cudaGetLastError();
}
