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
// Probe: one launch a call, with a mode that prunes in place of testing.
//   * Persistent blocks, at most kProbeBlocksPerSm an SM (the block count
//     of the wrapper's _build.scatter_grid over tiles of kProbeTileKeys,
//     no more than there are tiles), over strided tiles.  Few blocks, so
//     the int32 bitset is read from L2 at most a few hundred times a call.
//   * Prologue: each block packs the int32 0/1 bitset into shared memory.
//     Every thread first issues kPackLoads 16-byte loads of it, all before
//     any packing (at 16,384 bits and 512 threads: 8 independent loads a
//     thread, one round trip), then turns each into a nibble and ORs the 8
//     nibbles of a word together with three shuffles.  The keys of the
//     block's first tile are requested before the bitset, so the two round
//     trips overlap.  A bitset that is not 16-byte aligned, or whose length
//     is not a multiple of 32, is packed with one ballot per 32 bits.
//   * Key stream: a thread takes kProbeUnroll vectors of 4 keys a tile, one
//     16-byte load each (a warp's vector is 512 contiguous bytes), and loads
//     its next tile's keys before it tests the current one, so 32 bytes a
//     thread (32 KB an SM) stay in flight.  Each hash is applied to all of
//     a thread's keys in turn, so the loop over num_hashes costs once a
//     tile.  Two vectors a thread and two blocks an SM measured fastest
//     over the join path's probe sides, against four vectors and one or
//     three blocks an SM.  A power-of-two num_bits (every size the join path uses)
//     takes the modulo as a mask.  Scalar loads and stores for unaligned
//     views and at the ragged end.
//   * Output: 4 bools as one 4-byte store, or, in the prune mode (the
//     join's `where(probe(bits, keys), keys, NULL_KEY)`), the 4 keys or
//     NULL_KEY as one 16-byte store.  So the join reads each key once and
//     writes 4 bytes a key, in one pass in place of two.
//
// Launch: on the caller's stream, no synchronisation, no allocation.  The
// wrapper handles N == 0 without a launch.  Returns cudaGetLastError() (or
// cudaErrorInvalidValue for a grid it refuses) as an int.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;    // the build's tiles: 512 threads x 4 keys
constexpr int kVec = 4;
constexpr int64_t kTileKeys = kThreads * kVec;
constexpr int kProbeThreads = 512;
constexpr int kProbeUnroll = 2;  // vectors of kVec keys a thread a tile
constexpr int64_t kProbeTileKeys = kProbeThreads * kVec * kProbeUnroll;
constexpr int kProbeBlocksPerSm = 2;
constexpr int kPackLoads = 8;    // 16-byte loads of the bitset a thread a round
constexpr int32_t kNullKey = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

// hash i of a key is key * mul(i) + add(i), then h ^= h >> 15
__device__ __forceinline__ uint32_t hash_mul(uint32_t i) {
  return 2654435761u + 40503u * i;
}

__device__ __forceinline__ uint32_t mix(int32_t key, uint32_t mul,
                                        uint32_t add) {
  const uint32_t h = (uint32_t)key * mul + add;
  return h ^ (h >> 15);
}

__device__ __forceinline__ uint32_t bloom_hash(int32_t key, uint32_t i) {
  return mix(key, hash_mul(i), 97u * i);
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

// The int32 0/1 bitset packed into words_s: bit j of word w is
// bits[32 w + j] > 0.  kVecBits: bits is 16-byte aligned and num_bits a
// multiple of 32, so a warp's 16-byte loads cover whole words.
template <bool kVecBits>
__device__ __forceinline__ void pack_bits(const int32_t* __restrict__ bits,
                                          uint32_t num_bits,
                                          uint32_t* words_s) {
  const uint32_t lane = threadIdx.x & 31;
  if (kVecBits) {
    // lanes 8g..8g+7 hold the 8 quads of one word (quads % 8 == 0, and a
    // group starts at a multiple of 8: in or out of range as a whole)
    const uint32_t quads = num_bits / 4;
    const int4* q4 = reinterpret_cast<const int4*>(bits);
    for (uint32_t base = 0; base < quads;
         base += kProbeThreads * kPackLoads) {
      int4 q[kPackLoads];
#pragma unroll
      for (int k = 0; k < kPackLoads; ++k) {   // every load, then packing
        const uint32_t i = base + k * kProbeThreads + threadIdx.x;
        q[k] = i < quads ? __ldg(q4 + i) : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int k = 0; k < kPackLoads; ++k) {
        const uint32_t i = base + k * kProbeThreads + threadIdx.x;
        uint32_t x = ((uint32_t)(q[k].x > 0) | (uint32_t)(q[k].y > 0) << 1 |
                      (uint32_t)(q[k].z > 0) << 2 |
                      (uint32_t)(q[k].w > 0) << 3)
                     << (4 * (lane & 7));
        x |= __shfl_xor_sync(kFull, x, 1);
        x |= __shfl_xor_sync(kFull, x, 2);
        x |= __shfl_xor_sync(kFull, x, 4);
        if ((lane & 7) == 0 && i < quads) words_s[i / 8] = x;
      }
    }
  } else {
    // one ballot per word: every lane of a warp shares w
    const uint32_t words = (num_bits + 31) / 32;
    for (uint32_t w = threadIdx.x >> 5; w < words; w += kProbeThreads / 32) {
      const uint32_t j = w * 32 + lane;
      const uint32_t word =
          __ballot_sync(kFull, j < num_bits && __ldg(bits + j) > 0);
      if (lane == 0) words_s[w] = word;
    }
  }
}

// A thread's kProbeUnroll vectors of a tile: vector u at
// tile + (u * kProbeThreads + threadIdx.x) * kVec.  Keys past n read 0.
template <bool kAligned>
__device__ __forceinline__ void load_keys(const int32_t* __restrict__ keys,
                                          int64_t n, int64_t tile,
                                          int32_t (&k)[kProbeUnroll][kVec]) {
#pragma unroll
  for (int u = 0; u < kProbeUnroll; ++u) {
    const int64_t e = tile + ((int64_t)u * kProbeThreads + threadIdx.x) * kVec;
    if (kAligned && e + kVec <= n) {
      const int4 k4 = __ldg(reinterpret_cast<const int4*>(keys + e));
      k[u][0] = k4.x, k[u][1] = k4.y, k[u][2] = k4.z, k[u][3] = k4.w;
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        k[u][j] = e + j < n ? __ldg(keys + e + j) : 0;
    }
  }
}

// kPrune: out is int32, the key where every hash's bit is set and NULL_KEY
// elsewhere; else out is bool, the test itself.
template <bool kAligned, bool kPow2, bool kPrune>
__global__ void __launch_bounds__(kProbeThreads, kProbeBlocksPerSm)
bloom_probe_kernel(const int32_t* __restrict__ bits, uint32_t num_bits,
                   uint32_t num_hashes, bool vec_bits,
                   const int32_t* __restrict__ keys, int64_t n,
                   void* __restrict__ out) {
  extern __shared__ uint32_t words_s[];
  int64_t tile = (int64_t)blockIdx.x * kProbeTileKeys;
  int32_t k[kProbeUnroll][kVec];
  load_keys<kAligned>(keys, n, tile, k);    // in flight during the prologue
  if (vec_bits)
    pack_bits<true>(bits, num_bits, words_s);
  else
    pack_bits<false>(bits, num_bits, words_s);
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * kProbeTileKeys;
  for (;;) {
    const int64_t next = tile + stride;
    int32_t kn[kProbeUnroll][kVec];
    if (next < n) load_keys<kAligned>(keys, n, next, kn);
    uint32_t hit[kProbeUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kProbeUnroll; ++u)
#pragma unroll
      for (int j = 0; j < kVec; ++j) hit[u][j] = 1u;
    for (uint32_t i = 0; i < num_hashes; ++i) {
      const uint32_t mul = hash_mul(i), add = 97u * i;
#pragma unroll
      for (int u = 0; u < kProbeUnroll; ++u)
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const uint32_t h = mix(k[u][j], mul, add);
          const uint32_t p = kPow2 ? h & (num_bits - 1) : h % num_bits;
          hit[u][j] &= words_s[p >> 5] >> (p & 31);
        }
    }
#pragma unroll
    for (int u = 0; u < kProbeUnroll; ++u) {
      const int64_t e =
          tile + ((int64_t)u * kProbeThreads + threadIdx.x) * kVec;
      int32_t r[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        r[j] = kPrune ? ((hit[u][j] & 1u) ? k[u][j] : kNullKey)
                      : (int32_t)(hit[u][j] & 1u);
      if (kAligned && e + kVec <= n) {
        if (kPrune)
          *reinterpret_cast<int4*>((int32_t*)out + e) =
              make_int4(r[0], r[1], r[2], r[3]);
        else
          *reinterpret_cast<uint32_t*>((bool*)out + e) =
              (uint32_t)r[0] | (uint32_t)r[1] << 8 | (uint32_t)r[2] << 16 |
              (uint32_t)r[3] << 24;
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          if (e + j >= n) break;
          if (kPrune)
            ((int32_t*)out)[e + j] = r[j];
          else
            ((bool*)out)[e + j] = r[j];
        }
      }
    }
    if (next >= n) break;
#pragma unroll
    for (int u = 0; u < kProbeUnroll; ++u)
#pragma unroll
      for (int j = 0; j < kVec; ++j) k[u][j] = kn[u][j];
    tile = next;
  }
}

using ProbeKernel = void (*)(const int32_t*, uint32_t, uint32_t, bool,
                             const int32_t*, int64_t, void*);

template <bool kAligned, bool kPow2>
ProbeKernel probe_kernel(bool prune) {
  return prune ? &bloom_probe_kernel<kAligned, kPow2, true>
               : &bloom_probe_kernel<kAligned, kPow2, false>;
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

// bits int32 0/1 (num_bits), keys int32 (n) -> out bool (n), or with
// prune != 0 out int32 (n): the key where the probe hits, NULL_KEY where
// it misses.  blocks: the wrapper's _build.scatter_grid block count over
// kProbeTileKeys tiles; the entry refuses a block without a tile.
extern "C" int repro_bloom_probe(const void* bits, const void* keys, void* out,
                                 int64_t n, int64_t num_bits,
                                 int64_t num_hashes, int64_t blocks,
                                 int64_t prune, void* stream) {
  if (n <= 0 || num_bits <= 0 || num_bits > (1ll << 31) - 32 ||
      num_hashes < 0 || blocks <= 0 ||
      blocks > (n + kProbeTileKeys - 1) / kProbeTileKeys ||
      blocks > (1ll << 31) - 1)
    return (int)cudaErrorInvalidValue;
  const uint32_t nb = (uint32_t)num_bits;
  const size_t smem = sizeof(uint32_t) * ((nb + 31) / 32);
  const bool aligned = (uintptr_t)keys % 16 == 0 && (uintptr_t)out % 16 == 0;
  const bool pow2 = (nb & (nb - 1)) == 0;
  const bool vec_bits = (uintptr_t)bits % 16 == 0 && nb % 32 == 0;
  const ProbeKernel kernel =
      aligned ? (pow2 ? probe_kernel<true, true>(prune != 0)
                      : probe_kernel<true, false>(prune != 0))
              : (pow2 ? probe_kernel<false, true>(prune != 0)
                      : probe_kernel<false, false>(prune != 0));
  kernel<<<(unsigned)blocks, kProbeThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)bits, nb, (uint32_t)num_hashes, vec_bits,
      (const int32_t*)keys, n, out);
  return (int)cudaGetLastError();
}
