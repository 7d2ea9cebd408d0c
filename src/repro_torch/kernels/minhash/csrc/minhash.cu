// Canonical k-mer hashing for Hopper (sm_90a), hand-written CUDA.
//
// Replaces src/repro/kernels/minhash/kernel.py: _kmer_kernel (l.33, via
// kmer_hash_call l.49), the front half of the paper's metagenomics
// pipeline (§V-C).
//
// Input: rows of uint8 base codes (0..3; anything above 3 is an N), (rows,
// length) row-major.  Output: for each row and each start t < length - k
// + 1, the murmur3 fmix32 hash of the canonical k-mer at t — the smaller
// of its forward word (2 bits per base, first base highest, low 32 bits
// kept) and its reverse-complement word (base j's complement at bits 2j;
// a base past the 16th shifts out, written here as an explicit 0 since a
// C++ shift by 32 or more is undefined) — or INVALID = 0xFFFFFFFF where
// the window holds an N.  Bit-identical to the plain version in
// repro_torch/kernels/minhash/ref.py.
//
// What bounds it: each base is read once per tile (plus the k - 1 bases of
// overlap with the next tile) and each hash written once: 1 byte in, 4
// bytes out per k-mer, far below the card's 3.35 TB/s only if the k
// shift-or steps per k-mer keep up.  The design: one block of kTile
// threads per (row, tile of kTile starts) stages the tile's kTile + k - 1
// bases in shared memory with coalesced byte loads (past the row's end it
// stores the invalid code 255, as the JAX wrapper's padding does); each
// thread then builds its two words in k steps from shared memory and
// writes one coalesced word.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;  // k-mer starts per block, one per thread
constexpr uint32_t kInvalid = 0xFFFFFFFFu;
constexpr uint8_t kPad = 255;
constexpr int kMaxShared = 48 * 1024;  // static-launch shared memory limit

__device__ __forceinline__ uint32_t mix_murmur3(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__global__ void __launch_bounds__(kTile)
kmer_kernel(const uint8_t* __restrict__ bases, uint32_t* __restrict__ out,
            long long length, long long n_out, int k, long long tiles) {
  extern __shared__ uint8_t tile[];
  const long long row = blockIdx.x / tiles;
  const long long t0 = (blockIdx.x % tiles) * kTile;
  const uint8_t* src = bases + row * length;
  for (int i = threadIdx.x; i < kTile + k - 1; i += kTile) {
    const long long pos = t0 + i;
    tile[i] = pos < length ? src[pos] : kPad;
  }
  __syncthreads();
  const long long t = t0 + threadIdx.x;
  if (t >= n_out) return;
  uint32_t fwd = 0, rev = 0;
  bool bad = false;
  for (int j = 0; j < k; ++j) {
    const uint32_t b = tile[threadIdx.x + j];
    bad |= b > 3u;
    const uint32_t code = b & 3u;
    fwd = (fwd << 2) | code;
    if (j < 16) rev |= (3u - code) << (2 * j);
  }
  out[row * n_out + t] = bad ? kInvalid : mix_murmur3(min(fwd, rev));
}

}  // namespace

// `bases` (rows, length) uint8, `out` (rows, length - k + 1) u32.  Launches
// on `stream`, allocates nothing, does not synchronise, and returns
// cudaGetLastError() of the launch (0 = success).
extern "C" int kmer_hash(const void* bases, void* out, long long rows,
                         long long length, int k, void* stream) {
  const long long n_out = length - k + 1;
  if (rows <= 0 || n_out <= 0) return 0;
  const long long tiles = (n_out + kTile - 1) / kTile;
  const long long shared = kTile + (long long)k - 1;
  if (k < 1 || shared > kMaxShared || rows * tiles >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  kmer_kernel<<<(unsigned)(rows * tiles), kTile, (size_t)shared,
                (cudaStream_t)stream>>>((const uint8_t*)bases,
                                        (uint32_t*)out, length, n_out, k,
                                        tiles);
  return (int)cudaGetLastError();
}
