// Masked histogram: counts[v] = number of valid slots i with values[i] == v,
// for v in [0, num_segments); values outside that range are not counted.
// The CSR build's row counts and the in/out degrees of the analytics.
//
// Replaces the Pallas TPU kernel src/repro/kernels/segment_csr.py
// (_hist_kernel).  That kernel lowers the scatter-add as a one-hot
// (TILE x SEG_BLOCK) matmul on the MXU over a sequential 2-D grid that
// accumulates into each output block.  On Hopper the histogram is atomic,
// and what bounds it is where the atomics land: sorted sources send the 32
// lanes of a warp to a few addresses, and on the JS-OJ graph one item hub
// takes 18% of Buy's targets.  One global atomicAdd per value serialises
// both in L2.
//
// Design: block-private aggregation in shared memory, as csrc/spmv.cu
// does for its float sums, with an int32 count in place of the sum.
//   * Persistent blocks (a few per SM; the block count of the wrapper's
//     _build.scatter_grid, which the C entry checks leaves no block
//     without a tile): block b takes the tiles of kTileValues values b,
//     b + blocks, b + 2 blocks, ...
//     A thread loads 4 values at once: values as one 16-byte load, valid
//     as one 4-byte word (scalar loads when the operands are not so
//     aligned, and at the input's ragged end).
//   * A table in shared memory, kSlots slots of (int32 key = value, int32
//     count), empty key -1, multiplicative hash and linear probing.  Each
//     lane claims or finds its value's slot (atomicCAS on the key, at most
//     kMaxProbe slots) and adds 1 with a shared atomicAdd, which is native
//     on int32 (ATOMS.ADD).  A lane whose probe finds no slot adds straight
//     into counts with a global atomic: part of the algorithm, so the
//     table never has to fit.
//   * The table lives across tiles: after a tile (__syncthreads) whose
//     inserts leave more than kFlushAt slots occupied, and after the last
//     one, every occupied slot is flushed into counts with one global
//     atomicAdd and emptied.  Less than a quarter full before a tile of
//     half as many values as slots, the table keeps probes short.  A hub,
//     a sorted run or a small key set (the JS-OJ graph's 502 outlets) then
//     costs one global atomic per flush instead of one per value: the
//     global atomics on a few hot lines of counts are what serialise in L2.
//   * A slot whose valid flag is off costs a byte: a thread reads its 4
//     values only when one of its 4 flags is on.  The CSR build passes
//     whole edge tables, whose capacity (a power of two) can be 4-6x the
//     valid rows.
// On values without repeats (random sources) the kernel does what one
// atomic per value did; what bounds it then is the rate of the L2's
// atomics.
//
// A warp step before the table (lanes with equal values merged with
// __match_any_sync, the group's lowest lane adding __popc of it) measured
// slower on every operand of the paths, since the shared int32 atomic is
// native; so did one global atomic per value (PERF.md).
//
// Bound.  1 byte per slot (the flag), 4 per valid slot (its value) and 4
// per bin written; the counts (600k bins x 4 B = 2.4 MB on the JS-OJ
// graph) stay in the 50 MB L2, so the global atomics resolve there.
//
// Launch: on the caller's stream, no synchronisation, no allocation; the
// wrapper zeroes counts on the stream and handles n == 0 and
// num_segments == 0 without a launch.  Returns cudaGetLastError() (or
// cudaErrorInvalidValue for a grid with more blocks than tiles) as an int.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kVec = 4;                           // values per thread a tile
constexpr int64_t kTileValues = kThreads * kVec;  // 2,048
constexpr int kSlotBits = 12;
constexpr int kSlots = 1 << kSlotBits;            // 4,096: 32 KB of table
constexpr int kMaxProbe = 16;
constexpr int kFlushAt = kSlots / 4;
constexpr int32_t kEmpty = -1;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned home_slot(int32_t v) {
  return ((uint32_t)v * 2654435769u) >> (32 - kSlotBits);
}

// Add 1 to key v's slot, counting a slot this lane claims in claims;
// false when no slot within kMaxProbe is v's.
__device__ __forceinline__ bool table_add(int32_t* keys, int32_t* cnt,
                                          int& claims, int32_t v) {
  const volatile int32_t* vkeys = keys;
  unsigned slot = home_slot(v);
  for (int p = 0; p < kMaxProbe; ++p, slot = (slot + 1) & (kSlots - 1)) {
    int32_t k = vkeys[slot];
    if (k == kEmpty) {
      k = atomicCAS(keys + slot, kEmpty, v);
      claims += k == kEmpty;
    }
    if (k == kEmpty || k == v) {
      atomicAdd(cnt + slot, 1);
      return true;
    }
  }
  return false;
}

// One value a lane: into the table, or past the probe bound into counts.
__device__ __forceinline__ void count_value(int32_t v, bool ok,
                                            int64_t num_segments,
                                            int32_t* __restrict__ counts,
                                            int32_t* keys, int32_t* cnt,
                                            int& claims) {
  if (!ok || v < 0 || (int64_t)v >= num_segments) return;
  if (!table_add(keys, cnt, claims, v)) atomicAdd(counts + v, 1);
}

// Every occupied slot into counts with one global atomic, and emptied.
__device__ __forceinline__ void flush(int32_t* keys, int32_t* cnt,
                                      int32_t* __restrict__ counts) {
  for (int i = threadIdx.x; i < kSlots; i += kThreads) {
    const int32_t k = keys[i];
    if (k != kEmpty) {
      atomicAdd(counts + k, cnt[i]);
      keys[i] = kEmpty;
      cnt[i] = 0;
    }
  }
}

template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
segment_counts_kernel(const int32_t* __restrict__ values,
                      const bool* __restrict__ valid, int64_t n,
                      int64_t num_segments, int32_t* __restrict__ counts) {
  __shared__ int32_t keys[kSlots];
  __shared__ int32_t cnt[kSlots];
  // slots claimed in a tile, by the tile's parity: tile t counts into
  // claimed[t & 1] while thread 0 zeroes the other one, which every thread
  // read before the barrier that starts tile t
  __shared__ int claimed[2];
  for (int i = threadIdx.x; i < kSlots; i += kThreads) {
    keys[i] = kEmpty;
    cnt[i] = 0;
  }
  if (threadIdx.x < 2) claimed[threadIdx.x] = 0;
  // slots occupied since the last flush: the same in every thread, since
  // every thread adds the same shared counts
  int occupied = 0;
  int parity = 0;
  // strided tiles: block b takes tiles b, b + gridDim.x, ...  The paths'
  // tables are prefix-compacted (valid rows first, then padding), so
  // contiguous ranges would leave the blocks past the valid rows idle.
  const int64_t stride = (int64_t)gridDim.x * kTileValues;
  for (int64_t tile = (int64_t)blockIdx.x * kTileValues; tile < n;
       tile += stride, parity ^= 1) {
    const int64_t end = tile + kTileValues < n ? tile + kTileValues : n;
    __syncthreads();                 // a flush, if one was due, is done
    if (threadIdx.x == 0) claimed[parity ^ 1] = 0;
    const int64_t e = tile + (int64_t)threadIdx.x * kVec;
    int32_t v[kVec] = {-1, -1, -1, -1};
    bool ok[kVec];
    if (kAligned && e + kVec <= end) {
      // an invalid slot's value is never read
      const uint32_t f4 =
          __ldg(reinterpret_cast<const unsigned int*>(valid + e));
      if (f4) {
        const int4 v4 = __ldg(reinterpret_cast<const int4*>(values + e));
        v[0] = v4.x, v[1] = v4.y, v[2] = v4.z, v[3] = v4.w;
      }
#pragma unroll
      for (int k = 0; k < kVec; ++k) ok[k] = (f4 >> (8 * k)) & 0xffu;
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        ok[k] = e + k < end && valid[e + k];
        if (ok[k]) v[k] = __ldg(values + e + k);
      }
    }
    int claims = 0;
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      count_value(v[k], ok[k], num_segments, counts, keys, cnt, claims);
    // one shared atomic a warp, not one a claim
    claims = __reduce_add_sync(kFull, claims);
    if ((threadIdx.x & 31u) == 0 && claims)
      atomicAdd(claimed + parity, claims);
    __syncthreads();                 // the tile is in the table
    occupied += claimed[parity];
    if (occupied > kFlushAt) {
      flush(keys, cnt, counts);
      occupied = 0;
    }
  }
  // after the last tile's barrier: nothing inserts
  if (occupied > 0) flush(keys, cnt, counts);
}

}  // namespace

extern "C" int repro_segment_counts(const void* values, const void* valid,
                                    void* counts, int64_t n,
                                    int64_t num_segments, int64_t blocks,
                                    void* stream) {
  // strided tiles cover any grid; refuse one with a block and no tile
  if (n <= 0 || num_segments <= 0 || blocks <= 0 ||
      blocks > (n + kTileValues - 1) / kTileValues || blocks > (1ll << 31) - 1)
    return (int)cudaErrorInvalidValue;
  const bool aligned =
      (uintptr_t)values % 16 == 0 && (uintptr_t)valid % 4 == 0;
  auto kernel = aligned ? &segment_counts_kernel<true>
                        : &segment_counts_kernel<false>;
  kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)values, (const bool*)valid, n, num_segments,
      (int32_t*)counts);
  return (int)cudaGetLastError();
}
