// The blocked bloom filter's insert and query for Hopper (sm_90a),
// hand-written CUDA.
//
// Replaces src/repro/kernels/bloom/kernel.py: _insert_kernel (l.45, via
// insert_call l.65) with bloom_insert, and _query_kernel (l.83, via
// query_call l.98) with bloom_query.
//
// The filter is (planes, num_blocks, wpb) u32 words, row-major: one plane
// per filter of a stack (the elastic service keeps one per shard; a lone
// filter is one plane), one row of wpb words per block.  Per key k, in
// uint32_t arithmetic that wraps as the TPU kernel's u32 does:
//   block = murmur3(k ^ seed) mod num_blocks        (num_blocks is a prime)
//   h = xxhash(k ^ seed),  g = murmur3(k + 0x61C88647)
//   bit i (i < k_hashes) = (h + i * g) mod (32 * wpb)  in the block's row.
// Insert ORs the bits into the row; query reports 1 where every bit is set.
// An optional per-key plane index (int32) picks the plane; a key whose
// plane is out of range, or whose mask byte is 0, touches nothing and
// queries as 0.  Bit-identical to the plain versions in
// repro_torch/kernels/bloom/ops.py (and the hash arithmetic to
// repro_torch/core/hashing.py).
//
// What bounds them: each key touches one row (at 512-bit blocks one
// 64-byte row, two 32-byte sectors) at a random place in a filter far
// larger than the 50 MB L2, so both are bound by random sectors, not by
// the card's 3.35 TB/s on streams; the insert also writes each sector it
// touches.  The design: one thread per key; the key, mask, plane and
// output streams are read and written coalesced.  The insert merges the
// bits that fall into one word and issues one atomicOr per touched word
// (OR commutes and is idempotent, so the filter is bit-exact whatever the
// order of the keys); above kMergeK hashes it issues one atomicOr per bit.
// The query stops at the first bit that is clear.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMergeK = 16;  // hashes whose bits are merged per word
constexpr uint32_t kStepAdd = 0x61C88647u;

__device__ __forceinline__ uint32_t mix_murmur3(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t mix_xxhash(uint32_t x) {
  x ^= x >> 15;
  x *= 0x85EBCA77u;
  x ^= x >> 13;
  x *= 0xC2B2AE3Du;
  x ^= x >> 16;
  x *= 0x27D4EB2Fu;
  return x;
}

struct Geometry {
  uint32_t num_blocks;
  uint32_t bits;  // 32 * wpb: the bits of one block
  uint32_t seed;
  int wpb;        // u32 words per block
  int k;          // hashes (bits) per key
  int planes;
  bool pow2;      // bits is a power of two: mod is a mask
};

// The key's bit position i within its block.
__device__ __forceinline__ uint32_t position(const Geometry& geo, uint32_t h,
                                             uint32_t g, int i) {
  const uint32_t x = h + (uint32_t)i * g;
  return geo.pow2 ? (x & (geo.bits - 1u)) : x % geo.bits;
}

// The word offset of the key's row, and its two hashes; false when the
// key's plane is out of range.
__device__ __forceinline__ bool locate(const Geometry& geo, uint32_t key,
                                       const int32_t* planes, long long i,
                                       size_t* row, uint32_t* h,
                                       uint32_t* g) {
  const int plane = planes ? planes[i] : 0;
  if (plane < 0 || plane >= geo.planes) return false;
  const uint32_t block = mix_murmur3(key ^ geo.seed) % geo.num_blocks;
  *row = ((size_t)plane * geo.num_blocks + block) * (size_t)geo.wpb;
  *h = mix_xxhash(key ^ geo.seed);
  *g = mix_murmur3(key + kStepAdd);
  return true;
}

__global__ void __launch_bounds__(kThreads)
insert_kernel(uint32_t* __restrict__ words, const uint32_t* __restrict__ keys,
              const uint8_t* __restrict__ mask,
              const int32_t* __restrict__ planes, long long n, Geometry geo) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n || (mask && !mask[i])) return;
  size_t row;
  uint32_t h, g;
  if (!locate(geo, keys[i], planes, i, &row, &h, &g)) return;
  uint32_t* r = words + row;
  if (geo.k > kMergeK) {
    for (int j = 0; j < geo.k; ++j) {
      const uint32_t p = position(geo, h, g, j);
      atomicOr(r + (p >> 5), 1u << (p & 31u));
    }
    return;
  }
  uint32_t pos[kMergeK];
#pragma unroll
  for (int j = 0; j < kMergeK; ++j)
    pos[j] = j < geo.k ? position(geo, h, g, j) : 0u;
#pragma unroll
  for (int j = 0; j < kMergeK; ++j) {
    if (j < geo.k) {
      const uint32_t w = pos[j] >> 5;
      bool first = true;  // bit j is the first of the key's bits in word w
      uint32_t bits = 0;
#pragma unroll
      for (int m = 0; m < kMergeK; ++m) {
        if (m < geo.k && (pos[m] >> 5) == w) {
          first &= m >= j;
          bits |= 1u << (pos[m] & 31u);
        }
      }
      if (first) atomicOr(r + w, bits);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
query_kernel(const uint32_t* __restrict__ words,
             const uint32_t* __restrict__ keys,
             const int32_t* __restrict__ planes, uint8_t* __restrict__ out,
             long long n, Geometry geo) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  size_t row;
  uint32_t h, g;
  uint8_t hit = 0;
  if (locate(geo, keys[i], planes, i, &row, &h, &g)) {
    const uint32_t* r = words + row;
    hit = 1;
    for (int j = 0; j < geo.k; ++j) {
      const uint32_t p = position(geo, h, g, j);
      if (!((__ldg(r + (p >> 5)) >> (p & 31u)) & 1u)) {
        hit = 0;
        break;
      }
    }
  }
  out[i] = hit;
}

bool make_geometry(Geometry* geo, long long n, int planes,
                   unsigned num_blocks, int wpb, int k, unsigned seed) {
  if (n < 0 || planes < 1 || num_blocks < 1 || wpb < 1 || k < 0 ||
      (long long)wpb * 32 > 0xFFFFFFFFLL ||
      (n + kThreads - 1) / kThreads >= (1LL << 31))
    return false;
  geo->num_blocks = num_blocks;
  geo->bits = 32u * (uint32_t)wpb;
  geo->seed = seed;
  geo->wpb = wpb;
  geo->k = k;
  geo->planes = planes;
  geo->pow2 = (geo->bits & (geo->bits - 1u)) == 0u;
  return true;
}

}  // namespace

// `words` (planes, num_blocks, wpb) u32, updated in place; `keys` (n,) u32;
// `mask` (n,) uint8 or null (every key); `plane` (n,) int32 or null (plane
// 0).  Launches on `stream`, allocates nothing, does not synchronise, and
// returns cudaGetLastError() of the launch (0 = success).
extern "C" int bloom_insert(void* words, const void* keys, const void* mask,
                            const void* plane, long long n, int planes,
                            unsigned num_blocks, int wpb, int k,
                            unsigned seed, void* stream) {
  Geometry geo;
  if (!make_geometry(&geo, n, planes, num_blocks, wpb, k, seed))
    return (int)cudaErrorInvalidValue;
  if (n == 0 || k == 0) return 0;
  insert_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                  (cudaStream_t)stream>>>(
      (uint32_t*)words, (const uint32_t*)keys, (const uint8_t*)mask,
      (const int32_t*)plane, n, geo);
  return (int)cudaGetLastError();
}

// `out` (n,) uint8 (a bool tensor): 1 where the key's row holds every one
// of its bits.  Otherwise as bloom_insert.
extern "C" int bloom_query(const void* words, const void* keys,
                           const void* plane, void* out, long long n,
                           int planes, unsigned num_blocks, int wpb, int k,
                           unsigned seed, void* stream) {
  Geometry geo;
  if (!make_geometry(&geo, n, planes, num_blocks, wpb, k, seed))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  query_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                 (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const uint32_t*)keys, (const int32_t*)plane,
      (uint8_t*)out, n, geo);
  return (int)cudaGetLastError();
}
