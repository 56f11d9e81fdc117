// The join library: the probe (sorted_probe, first) and the pair expansion
// (join_expand, at the end of this file).
//
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

// ---------------------------------------------------------------------------
// Join expansion: every output slot of a join step mapped to its left row and
// its right row, with no atomics.
//
// Replaces no TPU kernel: the JAX package (src/repro/relational/join.py,
// _expansion) and this port's plain version (kernels/ref.py join_expand)
// scatter a 1 at every left row's end (index_add_ of clamp(cum, 0, C)) and
// scan.  On this card that scatter serialises: join outputs are
// prefix-compacted, so every padding row of a step's left side has
// cum == total and adds to one int64 word, 38-105M times in the later steps
// of a TPC-DS SF10 request (79 ms of one step's 89 on an H100).
//
// What it computes, for every slot j in [0, C), with n left rows:
//   row[j]     = min(#{i : cum[i] <= j}, n - 1)   (the first i with cum[i] > j)
//   start      = row > 0 ? cum[row - 1] : 0,  rank = j - start
//   matched[j] = rank < match_counts[row]
//   ridx[j]    = order[clamp(lo[row] + rank, 0, rc - 1)]  (0 when rc == 0)
//   valid[j]   = j < total = cum[n - 1]
// bit for bit what the plain version gives, padding slots included (n == 0:
// row 0, start 0, no match).
//
// Bound.  18 bytes written a slot (two int64, two flags), and read once the
// 16 bytes of cum, lo and match_counts of each left row a slot lands on and
// the 8 bytes of order of each distinct matched right row: 2.9 GB, 0.86 ms
// at 3.35 TB/s, for the last step of a TPC-DS SF10 request (2^27 slots,
// 28.8M rows reached).  The order reads are a gather: where the right side
// is large and its rows scattered, each 8-byte read moves a 32-byte sector.
//
// Design: each block owns a tile of kExpandTile consecutive slots.
//  * A first small kernel finds every tile's first row by bisecting cum in
//    global memory, one thread a tile boundary: bounds[t] = min(first i with
//    cum[i] > t * kExpandTile, n - 1).  The rows of tile t then lie in
//    [bounds[t], bounds[t + 1]], so the second kernel's blocks never search
//    the whole of cum.
//  * The tile stages cum[b - 1 .. e - 1] (b, e its bounds) in shared memory
//    when that stretch fits (kExpandStage), and each slot bisects it, from
//    the row of the thread's previous slot.  A stretch too long for shared
//    memory (a run of zero-count rows, as a selective inner join leaves) is
//    bisected in global memory inside the same bounds.
//  * A tile past total (the padding slots, most slots of the late steps)
//    has b == e: an empty search, every slot on row n - 1.
//  * Each thread takes 4 consecutive slots at a time: it finds their 4 rows
//    first, then loads their match counts and first matches, then their 4
//    entries of order, so that no load waits on a search or on another
//    slot's load (7% less time than one slot after another, on the
//    benchmark's steps).  It stores row and ridx as two 16-byte stores each
//    and the flags as one 4-byte store each: a warp writes 1 KB of each
//    int64 output.
// The output depends on nothing but the operands (no atomics, no order
// between blocks).
//
// Launch: two kernels on the caller's stream, no synchronisation, no
// allocation.  The wrapper handles C == 0 without a launch.  Returns
// cudaGetLastError() as an int.

namespace {

constexpr int kExpandThreads = 256;
constexpr int kExpandVec = 4;   // consecutive slots a thread stores at once
// = sorted_probe.EXPAND_TILE in the wrapper
constexpr int kExpandTile = kExpandThreads * kExpandVec * 2;
constexpr int kExpandStage = 4096;   // cum entries staged (32 KB)

// The first i in [lo, hi) with a[i] > j, else hi.
template <bool kGlobal>
__device__ __forceinline__ uint32_t first_above(const int64_t* __restrict__ a,
                                                uint32_t lo, uint32_t hi,
                                                int64_t j) {
  uint32_t n = hi - lo;
  while (n > 0) {
    const uint32_t h = n >> 1;
    const int64_t v = kGlobal ? __ldg(a + lo + h) : a[lo + h];
    if (v <= j) { lo += h + 1; n -= h + 1; } else n = h;
  }
  return lo;
}

__global__ void expand_bounds_kernel(const int64_t* __restrict__ cum,
                                     uint32_t n, int64_t n_bounds,
                                     int32_t* __restrict__ bounds) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_bounds) return;
  const uint32_t r = first_above<true>(cum, 0, n, t * (int64_t)kExpandTile);
  bounds[t] = (int32_t)min(r, n - 1);
}

__global__ void __launch_bounds__(kExpandThreads)
join_expand_kernel(const int64_t* __restrict__ cum,
                   const int32_t* __restrict__ match_counts,
                   const int32_t* __restrict__ lo,
                   const int64_t* __restrict__ order,
                   const int32_t* __restrict__ bounds, uint32_t n, int64_t rc,
                   int64_t capacity, int64_t* __restrict__ row_out,
                   int64_t* __restrict__ ridx_out,
                   uint8_t* __restrict__ matched_out,
                   uint8_t* __restrict__ valid_out) {
  // s_cum[k] = cum[b - 1 + k] for k in [0, e - b], s_cum[0] = 0 when b == 0
  __shared__ int64_t s_cum[kExpandStage + 1];
  const int64_t j0 = (int64_t)blockIdx.x * kExpandTile;
  const uint32_t b = n ? (uint32_t)bounds[blockIdx.x] : 0;
  const uint32_t e = n ? (uint32_t)bounds[blockIdx.x + 1] : 0;
  const int64_t total = n ? __ldg(cum + n - 1) : 0;
  const bool staged = e - b <= kExpandStage;
  if (staged) {
    for (uint32_t k = threadIdx.x; k <= e - b; k += kExpandThreads)
      s_cum[k] = (b + k > 0) ? __ldg(cum + b + k - 1) : 0;
    __syncthreads();
  }
  uint32_t r = b;   // the row of this thread's previous slot
  for (int64_t jb = j0 + (int64_t)threadIdx.x * kExpandVec;
       jb < j0 + kExpandTile && jb < capacity;
       jb += kExpandThreads * kExpandVec) {
    uint32_t rows[kExpandVec];
    int64_t start[kExpandVec];
#pragma unroll
    for (int v = 0; v < kExpandVec; ++v) {
      const int64_t j = jb + v;
      if (staged) {
        r = b + first_above<false>(s_cum, r - b + 1, e - b + 1, j) - 1;
        start[v] = s_cum[r - b];
      } else {
        r = first_above<true>(cum, r, e, j);
        start[v] = r > 0 ? __ldg(cum + r - 1) : 0;
      }
      rows[v] = r;
    }
    int32_t mc[kExpandVec], first[kExpandVec];
#pragma unroll
    for (int v = 0; v < kExpandVec; ++v) {
      mc[v] = n ? __ldg(match_counts + rows[v]) : 0;
      first[v] = n ? __ldg(lo + rows[v]) : 0;
    }
    int64_t ridx[kExpandVec];
    uint8_t matched[kExpandVec], valid[kExpandVec];
#pragma unroll
    for (int v = 0; v < kExpandVec; ++v) {
      const int64_t j = jb + v, rank = j - start[v];
      const int64_t pos = (int64_t)first[v] + rank;
      matched[v] = rank < mc[v];
      ridx[v] = rc > 0 ? __ldg(order + min(max(pos, (int64_t)0), rc - 1)) : 0;
      valid[v] = j < total;
    }
    if (jb + kExpandVec <= capacity) {
      longlong2* ro = reinterpret_cast<longlong2*>(row_out + jb);
      longlong2* io = reinterpret_cast<longlong2*>(ridx_out + jb);
      ro[0] = make_longlong2(rows[0], rows[1]);
      ro[1] = make_longlong2(rows[2], rows[3]);
      io[0] = make_longlong2(ridx[0], ridx[1]);
      io[1] = make_longlong2(ridx[2], ridx[3]);
      *reinterpret_cast<uchar4*>(matched_out + jb) =
          make_uchar4(matched[0], matched[1], matched[2], matched[3]);
      *reinterpret_cast<uchar4*>(valid_out + jb) =
          make_uchar4(valid[0], valid[1], valid[2], valid[3]);
    } else {
      for (int v = 0; v < kExpandVec && jb + v < capacity; ++v) {
        row_out[jb + v] = rows[v];
        ridx_out[jb + v] = ridx[v];
        matched_out[jb + v] = matched[v];
        valid_out[jb + v] = valid[v];
      }
    }
  }
}

}  // namespace

// bounds: scratch of n_bounds = ceil(capacity / kExpandTile) + 1 int32 on
// the card.  row and ridx 16-byte aligned, matched and valid 4-byte
// aligned (fresh allocations are).
extern "C" int repro_join_expand(const void* cum, const void* match_counts,
                                 const void* lo, const void* order,
                                 void* bounds, void* row, void* ridx,
                                 void* matched, void* valid, int64_t n,
                                 int64_t rc, int64_t capacity,
                                 int64_t n_bounds, void* stream) {
  const int64_t tiles = (capacity + kExpandTile - 1) / kExpandTile;
  if (capacity <= 0 || n < 0 || n > 0x7fffffff || rc < 0 ||
      n_bounds != tiles + 1 || tiles > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if ((((uintptr_t)row | (uintptr_t)ridx) & 15) ||
      (((uintptr_t)matched | (uintptr_t)valid) & 3))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0)
    expand_bounds_kernel<<<(unsigned)((n_bounds + 255) / 256), 256, 0, s>>>(
        (const int64_t*)cum, (uint32_t)n, n_bounds, (int32_t*)bounds);
  join_expand_kernel<<<(unsigned)tiles, kExpandThreads, 0, s>>>(
      (const int64_t*)cum, (const int32_t*)match_counts, (const int32_t*)lo,
      (const int64_t*)order, (const int32_t*)bounds, (uint32_t)n, rc,
      capacity, (int64_t*)row, (int64_t*)ridx, (uint8_t*)matched,
      (uint8_t*)valid);
  return (int)cudaGetLastError();
}
