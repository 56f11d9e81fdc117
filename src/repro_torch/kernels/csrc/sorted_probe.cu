// Join probe: (lo, hi) match range of every probe key in the sorted build keys.
//
// Replaces the Pallas TPU kernel src/repro/kernels/sorted_probe.py
// (_probe_kernel / _bisect): lo is the left bisection (first slot with
// sorted[j] >= key), hi the right one (first slot with sorted[j] > key),
// both int32, exactly as jnp.searchsorted(side="left"/"right").  Unlike the
// Pallas version there is no limit on the build size: that one copies the
// whole build side into VMEM.
//
// Bound.  At least 4P bytes read and 8P written for P probe keys (plus the
// 4S build bytes once).  A plain bisection over the build side in global
// memory is a chain of 2*(ceil(log2 S)+1) dependent loads per key (46 at
// S = 2.88M), so it is bound by load latency, not by DRAM bandwidth.
//
// Design: a shared-memory fence level.
//  * A first small kernel gathers the fence: every stride-th build key,
//    fence[f] = sorted[f * stride] for f < F = ceil(S / stride), with stride
//    = ceil(S / kMaxFence) chosen by the wrapper (sorted_probe.fence_stride),
//    so F <= kMaxFence (8192 keys, 32 KB), into a scratch array the wrapper
//    allocates.  Each block of the probe kernel then copies it into shared
//    memory with coalesced loads.  Gathering it in every block instead
//    costs a scattered load per fence key per block, which measured
//    slower at S = 2.88M.
//  * Each probe key bisects the fence in shared memory, for lo with "<" and
//    for hi with "<=": the first fence slot f with fence[f] >= key (> key)
//    puts the answer in ((f-1)*stride, f*stride].  Both searches then finish
//    in global memory inside that window of stride - 1 keys: ~9 levels at
//    S = 2.88M instead of ~23.  The fence and the window use the same
//    comparison, so duplicate runs longer than the stride (Zipf hubs) still
//    give exact bounds.  At S <= kMaxFence the stride is 1, the whole build
//    side sits in shared memory, and global memory is never searched.
//  * The two searches (lo and hi) run in lockstep, fence and window, so
//    each thread keeps two independent loads in flight.
//  * The grid is the blocks that fit on the card at once, striding over the
//    probe keys, so the fence is copied once per block.
//
// What most likely bounds it now (a reading of the timings, not a
// profile): each level of a window search is one scattered load per key,
// one L1 tag lookup per distinct 128-byte line of a warp's 32 keys, so the
// lookups and not DRAM bytes set the time; skewed probe keys (many equal
// keys in a warp) share lines and run faster than uniform ones.
//
// Launch: two kernels on the caller's stream, no synchronisation, no
// allocation.  The wrapper handles P == 0 and S == 0 without a launch (a
// grid of 0 blocks is a launch error).  Returns cudaGetLastError() as an
// int.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxFence = 8192;   // = sorted_probe.MAX_FENCE in the wrapper

// Lockstep lower bounds of one key in [lo, lo + n_lo) and [hi, hi + n_hi)
// of one array: the first slot with a[slot] >= key (lo) and with
// a[slot] > key (hi), or the window's end when there is none.  kGlobal
// reads the build side through the read-only cache, else the shared fence.
// Indices are 32-bit: S < 2^31.
template <bool kGlobal>
__device__ __forceinline__ void bisect_pair(const int32_t* __restrict__ a,
                                            uint32_t& lo, uint32_t n_lo,
                                            uint32_t& hi, uint32_t n_hi,
                                            int32_t key) {
  while (n_lo > 0 || n_hi > 0) {
    const uint32_t h_lo = n_lo >> 1, h_hi = n_hi >> 1;
    const bool go_lo = n_lo > 0, go_hi = n_hi > 0;
    int32_t v_lo = 0, v_hi = 0;
    if (go_lo) v_lo = kGlobal ? __ldg(a + lo + h_lo) : a[lo + h_lo];
    if (go_hi) v_hi = kGlobal ? __ldg(a + hi + h_hi) : a[hi + h_hi];
    if (go_lo) {
      if (v_lo < key) { lo += h_lo + 1; n_lo -= h_lo + 1; } else n_lo = h_lo;
    }
    if (go_hi) {
      if (v_hi <= key) { hi += h_hi + 1; n_hi -= h_hi + 1; } else n_hi = h_hi;
    }
  }
}

__global__ void gather_fence(const int32_t* __restrict__ sorted,
                             uint32_t stride, uint32_t n_fence,
                             int32_t* __restrict__ fence) {
  const uint32_t f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f < n_fence) fence[f] = __ldg(sorted + f * stride);
}

__global__ void __launch_bounds__(kThreads)
sorted_probe_kernel(const int32_t* __restrict__ sorted, uint32_t n_sorted,
                    uint32_t stride, const int32_t* __restrict__ fence_g,
                    uint32_t n_fence, const int32_t* __restrict__ probe,
                    int64_t n_probe, int32_t* __restrict__ lo_out,
                    int32_t* __restrict__ hi_out) {
  __shared__ int32_t fence[kMaxFence];
  for (uint32_t f = threadIdx.x; f < n_fence; f += kThreads)
    fence[f] = __ldg(fence_g + f);
  __syncthreads();

  const int64_t step = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n_probe;
       i += step) {
    const int32_t key = __ldg(probe + i);
    // the fence level: first fence slot >= key (lo) and > key (hi)
    uint32_t flo = 0, fhi = 0;
    bisect_pair<false>(fence, flo, n_fence, fhi, n_fence, key);
    // the window ((f-1)*stride, min(f*stride, S)] in global memory; its
    // last slot is the answer when every key inside is on the other side.
    // f * stride < S + stride <= 2^31 + 2^18: no 32-bit overflow.
    uint32_t lo = flo > 0 ? (flo - 1) * stride + 1 : 0;
    uint32_t hi = fhi > 0 ? (fhi - 1) * stride + 1 : 0;
    const uint32_t end_lo = min(flo * stride, n_sorted);
    const uint32_t end_hi = min(fhi * stride, n_sorted);
    bisect_pair<true>(sorted, lo, end_lo - lo, hi, end_hi - hi, key);
    lo_out[i] = (int32_t)lo;
    hi_out[i] = (int32_t)hi;
  }
}

// Blocks that fit on the card at once (SMs x resident blocks per SM).
cudaError_t resident_blocks(int* blocks) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, sorted_probe_kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    cached = sms * (per_sm > 0 ? per_sm : 1);
  }
  *blocks = cached;
  return cudaSuccess;
}

}  // namespace

// fence: scratch of at least ceil(n_sorted / stride) int32 on the card.
extern "C" int repro_sorted_probe(const void* sorted, const void* probe,
                                  void* lo, void* hi, void* fence,
                                  int64_t n_sorted, int64_t n_probe,
                                  int64_t stride, void* stream) {
  if (n_probe <= 0 || n_sorted <= 0 || n_sorted > 0x7fffffff || stride <= 0 ||
      stride > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const int64_t n_fence = (n_sorted + stride - 1) / stride;
  if (n_fence > kMaxFence) return (int)cudaErrorInvalidValue;
  int grid_max = 0;
  const cudaError_t err = resident_blocks(&grid_max);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  gather_fence<<<(unsigned)((n_fence + 255) / 256), 256, 0, s>>>(
      (const int32_t*)sorted, (uint32_t)stride, (uint32_t)n_fence,
      (int32_t*)fence);
  int64_t blocks = (n_probe + kThreads - 1) / kThreads;
  if (blocks > grid_max) blocks = grid_max;
  sorted_probe_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      (const int32_t*)sorted, (uint32_t)n_sorted, (uint32_t)stride,
      (const int32_t*)fence, (uint32_t)n_fence, (const int32_t*)probe,
      n_probe, (int32_t*)lo, (int32_t*)hi);
  return (int)cudaGetLastError();
}
