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
// What bounds it: 1 byte in and 4 bytes out per k-mer, a stream, if the
// arithmetic keeps up (about 20 integer operations a k-mer).  The rows of
// the path are short (reads of 150 bases, genome windows of 127), so the
// design does not tile by row.  The output is (rows, n_out) row-major with
// n_out = length - k + 1, and output f = row * n_out + t reads bases f +
// row * (k - 1) onwards: a run of outputs reads a run of bases, whatever
// the rows.  So:
// - the grid runs over the flat output index: a thread owns kOut
//   consecutive outputs, a block kBlockOut;
// - a block stages the span of bases its outputs read in shared memory
//   with 16-byte loads (a span wider than kSpan, at a large k, is read
//   from device memory directly);
// - a thread builds its first k-mer in k steps and rolls each later one in
//   by one base: fwd takes the new last base (masked to 2k bits below
//   k = 16), rev drops its first base and takes the base min(k, 16) - 1
//   of the new window at the top, and the N test compares the window's
//   start with the position of the last N read.  At a row's end the
//   thread skips the k - 1 bases that start no k-mer and builds anew;
// - each thread writes its outputs with 16-byte stores.  (Staging the
//   block's outputs in shared memory, so that a warp writes whole lines,
//   took 10% longer on an NVIDIA H100 80GB HBM3 at 700 W:
//   tools/probe_cops_update.py kmer.)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOut = 8;                      // outputs a thread
constexpr int kBlockOut = kThreads * kOut;   // outputs a block
constexpr int kSpan = 2 * kBlockOut;         // bytes of bases staged, at most
constexpr uint32_t kInvalid = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t mix_murmur3(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// x / d for u32 x by a u32 d fixed at launch: c = ceil(2^64 / d), x / d =
// (c * x) >> 64, exact for every 32-bit x and d >= 2 (Lemire, Kaser, Kurz,
// "Faster remainder by direct computation", 2019); d = 1 is its own case.
struct Divider {
  unsigned long long c;
  uint32_t d;
  __device__ __forceinline__ uint32_t div(uint32_t x) const {
    return d == 1u ? x : (uint32_t)__umul64hi(c, x);
  }
};

Divider make_divider(uint32_t d) {
  return Divider{d > 1u ? ~0ULL / d + 1 : 0ULL, d};
}

// The outputs' rows: by multiplies while every output index fits 32 bits
// (`narrow`), else by a 64-bit division.
struct Rows {
  Divider per_row;  // n_out, when narrow
  long long n_out;
  bool narrow;
  __device__ __forceinline__ long long of(long long f) const {
    return narrow ? (long long)per_row.div((uint32_t)f) : f / n_out;
  }
};

// The hashes of one thread's outputs: `count` (<= kOut) outputs from base
// `p` of `src`, the first `left` of them in the current row.  K is k when
// fixed at compile time (the path's 16), else 0 and k is `k_arg`.
template <int K>
__device__ __forceinline__ void hash_run(const uint8_t* src, int p, int left,
                                         int k_arg, int count, int n_out,
                                         uint32_t (&h)[kOut]) {
  const int k = K ? K : k_arg;
  const uint32_t fmask = k >= 16 ? 0xFFFFFFFFu : (1u << (2 * k)) - 1u;
  const int top = 2 * (min(k, 16) - 1);  // rev's entering base
  uint32_t fwd = 0, rev = 0;
  int last_n = p - 1;  // the position of the last N read
  bool fresh = true;
#pragma unroll
  for (int j = 0; j < kOut; ++j) {
    if (j < count) {
      if (fresh) {
        fwd = rev = 0;
        last_n = p - 1;
        for (int i = 0; i < k; ++i) {
          const uint32_t b = src[p + i];
          if (b > 3u) last_n = p + i;
          fwd = (fwd << 2) | (b & 3u);
          if (i < 16) rev |= (3u - (b & 3u)) << (2 * i);
        }
        fresh = false;
      } else {
        const uint32_t b = src[p + k - 1];
        if (b > 3u) last_n = p + k - 1;
        fwd = ((fwd << 2) | (b & 3u)) & fmask;
        const uint32_t c = k > 16 ? src[p + 15] : b;
        rev = (rev >> 2) | ((3u - (c & 3u)) << top);
      }
      h[j] = last_n >= p ? kInvalid : mix_murmur3(min(fwd, rev));
      ++p;
      if (--left == 0) {  // the row ends: the next starts k - 1 bases on
        p += k - 1;
        left = n_out;
        fresh = true;
      }
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
kmer_kernel(const uint8_t* __restrict__ bases, uint32_t* __restrict__ out,
            long long total, Rows rows, int k_arg) {
  __shared__ __align__(16) uint8_t span[kSpan];
  const int k = K ? K : k_arg;
  const long long f0 = (long long)blockIdx.x * kBlockOut;
  const long long f1 = min(total, f0 + kBlockOut);
  const long long lo = f0 + rows.of(f0) * (k - 1);
  const long long hi = f1 - 1 + rows.of(f1 - 1) * (k - 1) + k;
  const int mis = (int)((uintptr_t)(bases + lo) & 15u);
  const long long chunks = (hi - lo + mis + 15) >> 4;
  const bool staged = chunks * 16 <= kSpan;
  if (staged) {
    const uint4* from = reinterpret_cast<const uint4*>(bases + lo - mis);
    for (int c = threadIdx.x; c < chunks; c += kThreads)
      reinterpret_cast<uint4*>(span)[c] = __ldg(from + c);
  }
  __syncthreads();
  const long long f = f0 + (long long)threadIdx.x * kOut;
  uint32_t h[kOut];
  if (f < f1) {
    const long long row = rows.of(f);
    const long long t = f - row * rows.n_out;
    const int p = (int)(f + row * (k - 1) - lo);
    // at most kOut outputs follow, so the rows' lengths clamp to kOut + 1
    const int left = (int)min(rows.n_out - t, (long long)kOut + 1);
    const int n_out = (int)min(rows.n_out, (long long)kOut + 1);
    const int count = (int)min(f1 - f, (long long)kOut);
    if (staged)
      hash_run<K>(span + mis, p, left, k, count, n_out, h);
    else
      hash_run<K>(bases + lo, p, left, k, count, n_out, h);
  }
  if (f + kOut <= f1) {
#pragma unroll
    for (int q = 0; q < kOut / 4; ++q)
      reinterpret_cast<uint4*>(out + f)[q] =
          make_uint4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < kOut; ++j)
      if (f + j < f1) out[f + j] = h[j];
  }
}

// The largest k the kernel takes: a block's span of bases, up to
// kBlockOut * k + k bytes where every row is one k-mer long, is indexed in
// 32 bits (hash_run's base offsets).
constexpr int kMaxK = (int)(((1LL << 31) - 1) / (kBlockOut + 1));

}  // namespace

// `bases` (rows, length) uint8, `out` (rows, length - k + 1) u32, 16-byte
// aligned, 1 <= k <= kmer_hash_max_k().  Launches on `stream`, allocates
// nothing, does not synchronise, and returns cudaGetLastError() of the
// launch (0 = success).
extern "C" int kmer_hash(const void* bases, void* out, long long rows,
                         long long length, int k, void* stream) {
  const long long n_out = length - k + 1;
  if (rows <= 0 || n_out <= 0) return 0;
  const long long total = rows * n_out;
  const long long blocks = (total + kBlockOut - 1) / kBlockOut;
  if (k < 1 || k > kMaxK || ((uintptr_t)out & 15u) || blocks >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const bool narrow = total <= 0xFFFFFFFFLL;
  const Rows r{make_divider(narrow ? (uint32_t)n_out : 1u), n_out, narrow};
  const cudaStream_t s = (cudaStream_t)stream;
  if (k == 16)
    kmer_kernel<16><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const uint8_t*)bases, (uint32_t*)out, total, r, k);
  else
    kmer_kernel<0><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const uint8_t*)bases, (uint32_t*)out, total, r, k);
  return (int)cudaGetLastError();
}

// The largest k that kmer_hash takes (kMaxK).
extern "C" int kmer_hash_max_k() { return kMaxK; }
