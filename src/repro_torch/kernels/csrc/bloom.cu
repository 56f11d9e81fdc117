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
// Build: each block ORs the positions of its keys into a shared packed
// bitset (shared-memory atomicOr), then ORs its non-zero words into a
// packed global bitset (zeroed first on the stream); a small second pass
// expands the packed words to the int32 0/1 output.
// Probe: each block packs the int32 0/1 bitset into shared memory with one
// warp ballot per 32 bits, then each thread hashes its key num_hashes times
// and tests the bits.  The grid is capped at a few blocks per SM, so the
// bitset is re-read (from L2) only a few hundred times in all.
//
// Bound.  Build reads 5N bytes (key + valid flag) and writes 4*num_bits;
// probe reads 4N + 4*num_bits and writes N.  Both are DRAM-bandwidth bound:
// the hashing is a few integer operations per key, and the atomics and
// bit tests hit shared memory.
//
// Launch: on the caller's stream, no synchronisation, no allocation.  The
// wrapper handles N == 0 without a launch.  Returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 4;

__device__ __forceinline__ uint32_t bloom_pos(int32_t key, uint32_t i,
                                              uint32_t num_bits) {
  uint32_t h = (uint32_t)key * (2654435761u + 40503u * i) + 97u * i;
  h ^= h >> 15;
  return h % num_bits;
}

__global__ void bloom_build_kernel(const int32_t* __restrict__ keys,
                                   const bool* __restrict__ valid, int64_t n,
                                   uint32_t num_bits, uint32_t num_hashes,
                                   uint32_t* __restrict__ packed) {
  extern __shared__ uint32_t words_s[];
  const uint32_t words = (num_bits + 31) / 32;
  for (uint32_t w = threadIdx.x; w < words; w += blockDim.x) words_s[w] = 0;
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (!valid[i]) continue;
    const int32_t key = __ldg(keys + i);
    for (uint32_t h = 0; h < num_hashes; ++h) {
      const uint32_t p = bloom_pos(key, h, num_bits);
      atomicOr(&words_s[p >> 5], 1u << (p & 31));
    }
  }
  __syncthreads();
  for (uint32_t w = threadIdx.x; w < words; w += blockDim.x) {
    const uint32_t v = words_s[w];
    if (v) atomicOr(&packed[w], v);
  }
}

__global__ void bloom_unpack_kernel(const uint32_t* __restrict__ packed,
                                    uint32_t num_bits,
                                    int32_t* __restrict__ bits) {
  for (uint32_t j = blockIdx.x * blockDim.x + threadIdx.x; j < num_bits;
       j += gridDim.x * blockDim.x) {
    bits[j] = (int32_t)((packed[j >> 5] >> (j & 31)) & 1u);
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

unsigned grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  return (unsigned)blocks;
}

}  // namespace

// keys int32 (n), valid bool (n) -> packed uint32 scratch (ceil(num_bits/32))
// and bits int32 0/1 (num_bits).
extern "C" int repro_bloom_build(const void* keys, const void* valid,
                                 void* packed, void* bits, int64_t n,
                                 int64_t num_bits, int64_t num_hashes,
                                 void* stream) {
  if (n <= 0 || num_bits <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t nb = (uint32_t)num_bits;
  const size_t smem = sizeof(uint32_t) * ((nb + 31) / 32);
  cudaError_t err = cudaMemsetAsync(packed, 0, smem, s);
  if (err != cudaSuccess) return (int)err;
  bloom_build_kernel<<<grid_for(n), kThreads, smem, s>>>(
      (const int32_t*)keys, (const bool*)valid, n, nb, (uint32_t)num_hashes,
      (uint32_t*)packed);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bloom_unpack_kernel<<<grid_for(num_bits), kThreads, 0, s>>>(
      (const uint32_t*)packed, nb, (int32_t*)bits);
  return (int)cudaGetLastError();
}

// bits int32 0/1 (num_bits), keys int32 (n) -> out bool (n).
extern "C" int repro_bloom_probe(const void* bits, const void* keys, void* out,
                                 int64_t n, int64_t num_bits,
                                 int64_t num_hashes, void* stream) {
  if (n <= 0 || num_bits <= 0) return (int)cudaErrorInvalidValue;
  const uint32_t nb = (uint32_t)num_bits;
  const size_t smem = sizeof(uint32_t) * ((nb + 31) / 32);
  bloom_probe_kernel<<<grid_for(n), kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)bits, nb, (uint32_t)num_hashes, (const int32_t*)keys, n,
      (bool*)out);
  return (int)cudaGetLastError();
}
