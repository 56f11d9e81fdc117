// Bloom-filter semi-join prefilter: build a bitset of the valid build keys,
// then test probe keys against it ("possibly present", no false negatives).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/bloom.py:
// _build_kernel (bloom_build) and _probe_kernel (bloom_probe).
//
// Hash.  _hash (bloom.py) in uint32 arithmetic, bit for bit:
//   h = (uint32)key * (2654435761 + 40503*i) + 97*i;  h ^= h >> 15;
//   pos = h % num_bits
// Negative keys and NULL_KEY are reinterpreted as uint32, as
// astype(jnp.uint32) does.
//
// Layout.  The reference output is one int32 0/1 per bit (num_bits words).
// Inside the kernels the bitset is packed, 32 bits a word: at most 16384
// bits on the join path, so 512 words (2 KB) of shared memory.
//
// Build: one launch a call, with no fill of the output, no memset of the
// scratch and no second kernel to unpack it.
//   * Persistent blocks (the block count of the wrapper's
//     _build.scatter_grid, no more than there are tiles) take strided
//     tiles of kTileKeys keys (block b the tiles b, b + blocks, ...), with
//     4-byte loads of valid and, where one of the 4 flags is on, 16-byte
//     loads of keys (scalar loads for unaligned views and at the ragged
//     end).
//   * Each block ORs its keys' positions into a packed bitset in shared
//     memory, testing before it sets: it reads the word and skips the
//     atomicOr when the bit is already set.  Bits only go from 0 to 1, so
//     a stale read costs one extra atomic and never a lost bit; on the
//     join path's dense filters (2.88M keys into 16,384 bits) nearly every
//     atomic is skipped.  A power-of-two num_bits (every size the join
//     path uses) takes the hash's modulo as a mask.
//   * The block then ORs each word its keys set, where the global scratch
//     lacks a bit of it, into the scratch, fences, and takes a ticket.
//     The block that takes the last ticket reads the scratch from L2
//     (__ldcg), writes all num_bits int32 0/1 outputs, and leaves the
//     scratch and the ticket zero for the next call.
//   * The scratch is zeroed once, when the wrapper allocates it, and every
//     call leaves it zero; the wrapper keeps one per (device, stream).
//     Two streams cannot share one: two builds in flight at once would OR
//     into the same words and take tickets from one counter, so each would
//     count the other's blocks and read the other's bits.  On one stream
//     the calls run in order.
// Probe: each block packs the int32 0/1 bitset into shared memory with one
// warp ballot per 32 bits, then each thread hashes its key num_hashes times
// and tests the bits.  The grid is capped at a few blocks per SM, so the
// bitset is re-read (from L2) only a few hundred times in all.
//
// Bound.  Build reads N bytes of flags and 4 bytes per valid key, and
// writes 4*num_bits;
// probe reads 4N + 4*num_bits and writes N.  Both are DRAM-bandwidth bound:
// the hashing is a few integer operations per key, and the atomics and
// bit tests hit shared memory.
//
// Launch: on the caller's stream, no synchronisation, no allocation.  The
// wrapper handles N == 0 without a launch.  Returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;    // the build's tiles: 512 threads x 4 keys
constexpr int kVec = 4;
constexpr int64_t kTileKeys = kThreads * kVec;
constexpr int kProbeThreads = 256;
constexpr int64_t kProbeMaxBlocks = 132 * 4;

__device__ __forceinline__ uint32_t bloom_hash(int32_t key, uint32_t i) {
  uint32_t h = (uint32_t)key * (2654435761u + 40503u * i) + 97u * i;
  return h ^ (h >> 15);
}

__device__ __forceinline__ uint32_t bloom_pos(int32_t key, uint32_t i,
                                              uint32_t num_bits) {
  return bloom_hash(key, i) % num_bits;
}

// kPow2: num_bits is a power of two (the join path's sizes), so the
// modulo of the hash is a mask.
template <bool kAligned, bool kPow2>
__global__ void __launch_bounds__(kThreads)
bloom_build_kernel(const int32_t* __restrict__ keys,
                   const bool* __restrict__ valid, int64_t n,
                   uint32_t num_bits, uint32_t num_hashes,
                   uint32_t* __restrict__ packed,
                   unsigned int* __restrict__ ticket,
                   int32_t* __restrict__ bits) {
  extern __shared__ uint32_t words_s[];
  __shared__ bool last;
  const uint32_t words = (num_bits + 31) / 32;
  for (uint32_t w = threadIdx.x; w < words; w += kThreads) words_s[w] = 0;
  __syncthreads();
  const volatile uint32_t* vwords = words_s;
  // strided tiles, as in csrc/segment_csr.cu: the build side is
  // prefix-compacted, so contiguous ranges would idle the blocks past it
  const int64_t stride = (int64_t)gridDim.x * kTileKeys;
  for (int64_t tile = (int64_t)blockIdx.x * kTileKeys; tile < n;
       tile += stride) {
    const int64_t end = tile + kTileKeys < n ? tile + kTileKeys : n;
    const int64_t e = tile + (int64_t)threadIdx.x * kVec;
    int32_t k[kVec] = {0, 0, 0, 0};
    bool ok[kVec];
    if (kAligned && e + kVec <= end) {
      // an invalid slot's key is never read
      const uint32_t f4 =
          __ldg(reinterpret_cast<const unsigned int*>(valid + e));
      if (f4) {
        const int4 k4 = __ldg(reinterpret_cast<const int4*>(keys + e));
        k[0] = k4.x, k[1] = k4.y, k[2] = k4.z, k[3] = k4.w;
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j) ok[j] = (f4 >> (8 * j)) & 0xffu;
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        ok[j] = e + j < end && valid[e + j];
        if (ok[j]) k[j] = __ldg(keys + e + j);
      }
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      if (!ok[j]) continue;
      for (uint32_t i = 0; i < num_hashes; ++i) {
        const uint32_t h = bloom_hash(k[j], i);
        const uint32_t p = kPow2 ? h & (num_bits - 1) : h % num_bits;
        const uint32_t bit = 1u << (p & 31);
        if (!(vwords[p >> 5] & bit)) atomicOr(&words_s[p >> 5], bit);
      }
    }
  }
  __syncthreads();
  for (uint32_t w = threadIdx.x; w < words; w += kThreads) {
    const uint32_t v = words_s[w];
    if (v & ~__ldcg(packed + w)) atomicOr(packed + w, v);
  }
  __threadfence();                 // this block's bits before its ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();                 // every block's bits after the tickets
  for (uint32_t w = threadIdx.x; w < words; w += kThreads) {
    words_s[w] = __ldcg(packed + w);
    packed[w] = 0;
  }
  if (threadIdx.x == 0) *ticket = 0;
  __syncthreads();
  if (kPow2 && num_bits >= 32) {
    // a word a thread, as 8 16-byte stores of 4 int32 0/1 each (bits is
    // the wrapper's fresh allocation, so 16-byte aligned)
    int4* out = reinterpret_cast<int4*>(bits);
    for (uint32_t w = threadIdx.x; w < words; w += kThreads) {
      const uint32_t v = words_s[w];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        out[w * 8 + q] = make_int4((v >> (4 * q)) & 1u,
                                   (v >> (4 * q + 1)) & 1u,
                                   (v >> (4 * q + 2)) & 1u,
                                   (v >> (4 * q + 3)) & 1u);
    }
  } else {
    for (uint32_t j = threadIdx.x; j < num_bits; j += kThreads)
      bits[j] = (int32_t)((words_s[j >> 5] >> (j & 31)) & 1u);
  }
}

__global__ void bloom_probe_kernel(const int32_t* __restrict__ bits,
                                   uint32_t num_bits, uint32_t num_hashes,
                                   const int32_t* __restrict__ keys, int64_t n,
                                   bool* __restrict__ out) {
  extern __shared__ uint32_t words_s[];
  const uint32_t words = (num_bits + 31) / 32;
  const uint32_t lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t nwarps = blockDim.x >> 5;
  // every lane of a warp shares w, so the ballot is warp-uniform
  for (uint32_t w = warp; w < words; w += nwarps) {
    const uint32_t j = w * 32 + lane;
    const bool set = j < num_bits && __ldg(bits + j) > 0;
    const uint32_t word = __ballot_sync(0xffffffffu, set);
    if (lane == 0) words_s[w] = word;
  }
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int32_t key = __ldg(keys + i);
    bool hit = true;
    for (uint32_t h = 0; h < num_hashes; ++h) {
      const uint32_t p = bloom_pos(key, h, num_bits);
      hit = hit && ((words_s[p >> 5] >> (p & 31)) & 1u);
    }
    out[i] = hit;
  }
}

unsigned probe_grid(int64_t n) {
  int64_t blocks = (n + kProbeThreads - 1) / kProbeThreads;
  if (blocks > kProbeMaxBlocks) blocks = kProbeMaxBlocks;
  if (blocks < 1) blocks = 1;
  return (unsigned)blocks;
}

}  // namespace

// keys int32 (n), valid bool (n) -> bits int32 0/1 (num_bits); packed
// (ceil(num_bits / 32) uint32) and ticket (one uint32) are the wrapper's
// zeroed scratch, left zero.  Strided tiles cover any grid: the entry
// refuses one with a block and no tile, whose ticket would still count.
extern "C" int repro_bloom_build(const void* keys, const void* valid,
                                 void* packed, void* ticket, void* bits,
                                 int64_t n, int64_t num_bits,
                                 int64_t num_hashes, int64_t blocks,
                                 void* stream) {
  if (n <= 0 || num_bits <= 0 || num_bits > (1ll << 31) - 32 || blocks <= 0 ||
      blocks > (n + kTileKeys - 1) / kTileKeys || blocks > (1ll << 31) - 1)
    return (int)cudaErrorInvalidValue;
  const uint32_t nb = (uint32_t)num_bits;
  const size_t smem = sizeof(uint32_t) * ((nb + 31) / 32);
  const bool aligned = (uintptr_t)keys % 16 == 0 && (uintptr_t)valid % 4 == 0;
  const bool pow2 = (nb & (nb - 1)) == 0;
  auto kernel = aligned ? (pow2 ? &bloom_build_kernel<true, true>
                                : &bloom_build_kernel<true, false>)
                        : (pow2 ? &bloom_build_kernel<false, true>
                                : &bloom_build_kernel<false, false>);
  kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)keys, (const bool*)valid, n, nb, (uint32_t)num_hashes,
      (uint32_t*)packed, (unsigned int*)ticket,
      (int32_t*)bits);
  return (int)cudaGetLastError();
}

// bits int32 0/1 (num_bits), keys int32 (n) -> out bool (n).
extern "C" int repro_bloom_probe(const void* bits, const void* keys, void* out,
                                 int64_t n, int64_t num_bits,
                                 int64_t num_hashes, void* stream) {
  if (n <= 0 || num_bits <= 0) return (int)cudaErrorInvalidValue;
  const uint32_t nb = (uint32_t)num_bits;
  const size_t smem = sizeof(uint32_t) * ((nb + 31) / 32);
  bloom_probe_kernel<<<probe_grid(n), kProbeThreads, smem,
                       (cudaStream_t)stream>>>(
      (const int32_t*)bits, nb, (uint32_t)num_hashes, (const int32_t*)keys, n,
      (bool*)out);
  return (int)cudaGetLastError();
}
