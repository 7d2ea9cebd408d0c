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
// touches.  The direct design: one thread per key; the key, mask, plane
// and output streams are read and written coalesced.  The insert merges
// the bits that fall into one word and issues one atomicOr per touched
// word (OR commutes and is idempotent, so the filter is bit-exact whatever
// the order of the keys); above kMergeK hashes it issues one atomicOr per
// bit.  The query loads every word of the key's bits (up to kLoadBits
// hashes) before it tests any, so they do not wait on each other; the
// key's block is taken with multiplies (`Divider`), not a division.
//
// A batch that visits each sector of a filter larger than L2 many times
// would fetch (and the insert write back) every sector that often.  So
// both have a second path (bloom_insert_partitioned,
// bloom_query_partitioned; the wrapper picks it by keys per filter sector,
// kernels/bloom/ops.py:insert_plan, query_plan).  The filter's flat rows
// (plane * num_blocks + block) are cut into tiles of at most kTileWords
// words (64 KiB), and the tiles into ranges of tiles_per_range tiles
// (4 MiB); the keys are sorted by tile in two passes, then each tile's keys
// meet the tile in shared memory:
//   1. histogram_kernel counts the kept keys of each tile (masked keys and
//      keys whose plane is out of range are dropped), in shared memory
//      over a grid-stride loop, one global atomic per block and tile;
//   2. scan_kernel turns the counts into each tile's and each range's
//      first slot;
//   3. scatter_kernel<false> sorts each block's 2048 keys by range in
//      shared memory and writes each range's run coalesced into a first
//      scratch, at the slot that range's cursor hands out (one global
//      atomic per block and range);
//   4. scatter_kernel<true> does the same within each range, by tile, into
//      a second scratch: a range's 2048 keys fall into its few hundred
//      tiles, so the runs stay whole sectors;
//   5. the insert: tile_insert_kernel gives each tile a block, which ORs the
//      tile's keys' bits into a copy of the tile in shared memory (shared
//      atomics), then ORs the copy into the filter: each word the keys
//      touch is read and written once, by the one block that owns it.
//      Reordering the keys changes nothing: OR is order-free.
//      The query: each scatter also writes, in its input's order, the slot
//      it gave each key (two slot arrays: batch -> first scratch, first ->
//      second scratch).  tile_query_kernel loads each tile into shared
//      memory once and writes each of its keys' answers at the key's slot
//      of the second scratch, coalesced; then
//   6. gather_kernel brings the answers into the first scratch's order and
//   7. into the batch's (0 for a key dropped by the histogram), each through
//      its slot array: a scatter block writes its keys in a few hundred
//      runs, so consecutive slots read runs of answers, not random bytes.
// The scratch and the counts come from the caller.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMergeK = 16;  // hashes whose bits are merged per word
// the partitioned insert: keys a tile of the histogram and the scatter (8 a
// thread), and the most ranges it cuts a filter into
constexpr int kTileKeys = 8 * kThreads;
// ... the most bins (ranges, or tiles of a range) one of its passes sorts a
// block's keys into, the most tiles it cuts a filter into (its histogram:
// 128 KiB of shared memory), and the most words of a tile (64 KiB of
// shared memory, ORed by kTileThreads threads)
constexpr int kMaxLocal = 1024;
constexpr int kMaxTiles = 32768;
constexpr int kTileWords = 16384;
constexpr int kTileThreads = 512;
constexpr int kScanThreads = 1024;
constexpr int kUnroll = 4;  // keys a thread loads before it uses them
// the direct query: the most hashes whose words it loads before it tests any
constexpr int kLoadBits = 8;
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

// x / d and x % d for u32 x by a u32 d fixed at launch: c = ceil(2^64 / d),
// x / d = (c * x) >> 64 and x % d = ((c * x mod 2^64) * d) >> 64, exact
// for every 32-bit x and d >= 2 (Lemire, Kaser, Kurz, "Faster remainder by
// direct computation", 2019); d = 1 is its own case.  A few multiplies in
// place of the division the compiler emits for a divisor it cannot see.
struct Divider {
  unsigned long long c;
  uint32_t d;
  __device__ __forceinline__ uint32_t div(uint32_t x) const {
    return d == 1u ? x : (uint32_t)__umul64hi(c, x);
  }
  __device__ __forceinline__ uint32_t mod(uint32_t x) const {
    return d == 1u ? 0u : (uint32_t)__umul64hi(c * x, d);
  }
};

Divider make_divider(uint32_t d) {
  return Divider{d > 1u ? ~0ULL / d + 1 : 0ULL, d};
}

struct Geometry {
  uint32_t num_blocks;
  uint32_t bits;  // 32 * wpb: the bits of one block
  uint32_t seed;
  int wpb;        // u32 words per block
  int k;          // hashes (bits) per key
  int planes;
  uint32_t rows;  // planes * num_blocks (the partitioned insert's rows)
  bool pow2;      // bits is a power of two: mod is a mask
  Divider blocks; // num_blocks
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
  const uint32_t block = geo.blocks.mod(mix_murmur3(key ^ geo.seed));
  *row = ((size_t)plane * geo.num_blocks + block) * (size_t)geo.wpb;
  *h = mix_xxhash(key ^ geo.seed);
  *g = mix_murmur3(key + kStepAdd);
  return true;
}

// OR key (h, g)'s k bits into its row `r`: one atomicOr per touched word
// (bits of one word merged) up to kMergeK hashes, one per bit above.
__device__ __forceinline__ void or_bits(const Geometry& geo, uint32_t* r,
                                        uint32_t h, uint32_t g) {
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

// The direct path: one thread per key, in batch order.
__global__ void __launch_bounds__(kThreads)
insert_kernel(uint32_t* __restrict__ words, const uint32_t* __restrict__ keys,
              const uint8_t* __restrict__ mask,
              const int32_t* __restrict__ planes, long long n, Geometry geo) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n || (mask && !mask[i])) return;
  size_t row;
  uint32_t h, g;
  if (!locate(geo, keys[i], planes, i, &row, &h, &g)) return;
  or_bits(geo, words + row, h, g);
}

// The partitioned insert's cut of the filter's flat rows: tiles of
// rows_per_tile rows (at most kTileWords words, ORed in shared memory),
// and ranges of tiles_per_range tiles (the first pass's groups).  The
// counts buffer holds, in ints: count[tiles] (kept keys a tile),
// begin[tiles + 1] and cursor[tiles] (a tile's first and next slot in the
// second scratch), rbegin[ranges + 1] and rcursor[ranges] (the same for a
// range in the first scratch) and chunk[ranges + 1] (the first block of
// each range in the second pass).
struct Parts {
  uint32_t rows_per_tile;
  int tiles;
  int tiles_per_range;
  int ranges;
  Divider tile;    // rows_per_tile
  Divider range;   // rows_per_tile * tiles_per_range
  __host__ __device__ int* count(int* c) const { return c; }
  __host__ __device__ int* begin(int* c) const { return c + tiles; }
  __host__ __device__ int* cursor(int* c) const { return c + 2 * tiles + 1; }
  __host__ __device__ int* rbegin(int* c) const { return c + 3 * tiles + 1; }
  __host__ __device__ int* rcursor(int* c) const {
    return c + 3 * tiles + ranges + 2;
  }
  __host__ __device__ int* chunk(int* c) const {
    return c + 3 * tiles + 2 * ranges + 2;
  }
};

// Key i's flat row (plane * num_blocks + block), or -1 when the key is
// masked or its plane is out of range.
__device__ __forceinline__ long long flat_row(const Geometry& geo,
                                              uint32_t key,
                                              const uint8_t* mask,
                                              const int32_t* planes,
                                              long long i) {
  if (mask && !mask[i]) return -1;
  const int plane = planes ? planes[i] : 0;
  if (plane < 0 || plane >= geo.planes) return -1;
  return (uint32_t)plane * geo.num_blocks
         + geo.blocks.mod(mix_murmur3(key ^ geo.seed));
}

// Step 1: count[t] += the kept keys of tile t, the block's counts summed in
// shared memory over a grid-stride loop (a block of kScanThreads threads
// an SM).
__global__ void __launch_bounds__(kScanThreads)
histogram_kernel(const uint32_t* __restrict__ keys,
                 const uint8_t* __restrict__ mask,
                 const int32_t* __restrict__ planes, long long n,
                 Geometry geo, Parts pt, int* __restrict__ counts) {
  extern __shared__ int hist[];
  for (int t = threadIdx.x; t < pt.tiles; t += kScanThreads) hist[t] = 0;
  __syncthreads();
  const long long stride = (long long)gridDim.x * kScanThreads;
  for (long long i0 = (long long)blockIdx.x * kScanThreads + threadIdx.x;
       i0 < n; i0 += kUnroll * stride) {
    uint32_t key[kUnroll];  // loaded together, then counted
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i0 + u * stride < n) key[u] = keys[i0 + u * stride];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * stride;
      if (i >= n) break;
      const long long row = flat_row(geo, key[u], mask, planes, i);
      if (row >= 0) atomicAdd(&hist[pt.tile.div((uint32_t)row)], 1);
    }
  }
  __syncthreads();
  int* count = pt.count(counts);
  for (int t = threadIdx.x; t < pt.tiles; t += kScanThreads)
    if (hist[t]) atomicAdd(count + t, hist[t]);
}

// out[0 .. m] = the exclusive scan of in[0 .. m) (out[m]: the total), by a
// block of kScanThreads threads, each scanning a run of m / kScanThreads.
__device__ void block_exclusive_scan(const int* in, int* out, int m) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (m + kScanThreads - 1) / kScanThreads;
  const int lo = min(m, (int)threadIdx.x * per), hi = min(m, lo + per);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += in[i];
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = warp_sums[lane];
    int wi = w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, wi, d);
      if (lane >= d) wi += y;
    }
    warp_sums[lane] = wi - w;
  }
  __syncthreads();
  int run = warp_sums[warp] + incl - sum;
  for (int i = lo; i < hi; ++i) {
    const int x = in[i];
    out[i] = run;
    run += x;
  }
  if (threadIdx.x == kScanThreads - 1) out[m] = run;
  __syncthreads();
}

// Step 2: the tiles' and the ranges' first slots, cursors and the second
// pass's blocks of each range (see Parts), by one block.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(Parts pt, int* __restrict__ counts) {
  __shared__ int blocks[kMaxLocal];
  int* begin = pt.begin(counts);
  int* rbegin = pt.rbegin(counts);
  block_exclusive_scan(pt.count(counts), begin, pt.tiles);
  for (int t = threadIdx.x; t < pt.tiles; t += kScanThreads)
    pt.cursor(counts)[t] = begin[t];
  for (int r = threadIdx.x; r <= pt.ranges; r += kScanThreads)
    rbegin[r] = begin[min(r * pt.tiles_per_range, pt.tiles)];
  __syncthreads();
  for (int r = threadIdx.x; r < pt.ranges; r += kScanThreads) {
    pt.rcursor(counts)[r] = rbegin[r];
    blocks[r] = (rbegin[r + 1] - rbegin[r] + kTileKeys - 1) / kTileKeys;
  }
  __syncthreads();
  block_exclusive_scan(blocks, pt.chunk(counts), pt.ranges);
}

// In place: the exclusive scan of v[0 .. m) in shared memory (m <=
// kMaxLocal), by a block of kThreads threads.
__device__ void local_scan(int* v, int m) {
  __shared__ int carry[kMaxLocal / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = warp; c * 32 < m; c += kThreads / 32) {
    const int i = c * 32 + lane;
    const int x = i < m ? v[i] : 0;
    int incl = x;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (lane >= d) incl += y;
    }
    if (i < m) v[i] = incl - x;
    if (lane == 31) carry[c] = incl;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int c = 0; c * 32 < m; ++c) {
      const int t = carry[c];
      carry[c] = run;
      run += t;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < m; i += kThreads) v[i] += carry[i / 32];
  __syncthreads();
}

// Steps 3 and 4: a block's tile of up to kTileKeys keys, sorted by bin in
// shared memory and written coalesced, each bin's run at the slot its
// cursor hands out.  Step 3 (SECOND = false): the caller's keys into the
// first scratch by range (masked keys and planes out of range dropped).
// Step 4 (SECOND = true): each range's keys of the first scratch into the
// second by tile, the blocks of range r starting at chunk[r].  With SLOTS
// (the query), each key's slot in out_* (-1 for a dropped key) is written
// to `out_slots` at the key's own index, in its input's order.
template <bool SECOND, bool SLOTS>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const uint32_t* __restrict__ keys,
               const uint8_t* __restrict__ mask,
               const int32_t* __restrict__ planes, long long n, Geometry geo,
               Parts pt, int* __restrict__ counts,
               uint32_t* __restrict__ out_keys,
               int32_t* __restrict__ out_planes,
               int32_t* __restrict__ out_slots) {
  __shared__ int hist[kMaxLocal];   // this block's keys of each bin
  __shared__ int local[kMaxLocal];  // their first slot in the staging
  __shared__ int base[kMaxLocal];   // their first slot in out_*
  __shared__ uint32_t stage_keys[kTileKeys];
  __shared__ int32_t stage_planes[kTileKeys];
  __shared__ uint16_t stage_bin[kTileKeys];
  constexpr int kItems = kTileKeys / kThreads;
  long long lo, hi;
  uint32_t row0 = 0;
  Divider width;
  int bins;
  int* cursor;
  if (!SECOND) {
    lo = (long long)blockIdx.x * kTileKeys;
    hi = min(n, lo + kTileKeys);
    width = pt.range;
    bins = pt.ranges;
    cursor = pt.rcursor(counts);
  } else {
    const int* chunk = pt.chunk(counts);
    const int b = blockIdx.x;
    if (b >= chunk[pt.ranges]) return;  // whole blocks leave together
    int r = 0;  // the last range whose blocks start at or before b
    for (int step = kMaxLocal; step > 0; step >>= 1)
      if (r + step < pt.ranges && chunk[r + step] <= b) r += step;
    const int* rbegin = pt.rbegin(counts);
    lo = rbegin[r] + (long long)(b - chunk[r]) * kTileKeys;
    hi = min((long long)rbegin[r + 1], lo + kTileKeys);
    width = pt.tile;
    row0 = (uint32_t)r * pt.tiles_per_range * pt.rows_per_tile;
    bins = pt.tiles_per_range;
    cursor = pt.cursor(counts) + r * pt.tiles_per_range;
  }
  for (int b = threadIdx.x; b < bins; b += kThreads) hist[b] = 0;
  __syncthreads();
  int bin[kItems], slot[kItems];
  uint32_t key[kItems];  // loaded together, then sorted
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const long long i = lo + u * kThreads + threadIdx.x;
    if (i < hi) key[u] = keys[i];
  }
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const long long i = lo + u * kThreads + threadIdx.x;
    bin[u] = -1;
    if (i < hi) {
      const long long row = flat_row(geo, key[u], mask, planes, i);
      if (row >= 0) {
        bin[u] = width.div((uint32_t)row - row0);
        slot[u] = atomicAdd(&hist[bin[u]], 1);
      }
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < bins; b += kThreads) {
    local[b] = hist[b];
    if (hist[b]) base[b] = atomicAdd(cursor + b, hist[b]);
  }
  __syncthreads();
  local_scan(local, bins);
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const long long i = lo + u * kThreads + threadIdx.x;
    if (bin[u] >= 0) {
      const int at = local[bin[u]] + slot[u];
      stage_keys[at] = key[u];
      if (planes) stage_planes[at] = planes[i];
      stage_bin[at] = (uint16_t)bin[u];
    }
    if (SLOTS && i < hi)
      out_slots[i] = bin[u] >= 0 ? base[bin[u]] + slot[u] : -1;
  }
  __syncthreads();
  const int kept = local[bins - 1] + hist[bins - 1];
  for (int at = threadIdx.x; at < kept; at += kThreads) {
    const int b = stage_bin[at];
    const int to = base[b] + (at - local[b]);
    out_keys[to] = stage_keys[at];
    if (planes) out_planes[to] = stage_planes[at];
  }
}

// Step 5: block t ORs the keys of tile t (the second scratch's begin[t] ..
// begin[t + 1]) into a copy of the tile in shared memory that starts at
// zero, one shared atomicOr a bit, then ORs that copy into the filter:
// each word the keys touch is read and written once, by the block that
// owns its tile.
__global__ void __launch_bounds__(kTileThreads)
tile_insert_kernel(uint32_t* __restrict__ words,
                   const uint32_t* __restrict__ keys,
                   const int32_t* __restrict__ planes, Geometry geo,
                   Parts pt, const int* __restrict__ counts) {
  extern __shared__ uint32_t tile[];
  const uint32_t row0 = blockIdx.x * pt.rows_per_tile;
  const int size = (int)(min(pt.rows_per_tile, geo.rows - row0)) * geo.wpb;
  for (int w = threadIdx.x; w < size; w += kTileThreads) tile[w] = 0u;
  __syncthreads();
  const int* begin = pt.begin(const_cast<int*>(counts));
  const int hi = begin[blockIdx.x + 1];
  for (int i0 = begin[blockIdx.x] + threadIdx.x; i0 < hi;
       i0 += kUnroll * kTileThreads) {
    uint32_t key[kUnroll];  // loaded together, then ORed
    int plane[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kTileThreads;
      if (i < hi) {
        key[u] = keys[i];
        plane[u] = planes ? planes[i] : 0;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i0 + u * kTileThreads >= hi) break;
      const uint32_t row = (uint32_t)plane[u] * geo.num_blocks
                           + geo.blocks.mod(mix_murmur3(key[u] ^ geo.seed));
      uint32_t* r = tile + (size_t)(row - row0) * geo.wpb;
      const uint32_t h = mix_xxhash(key[u] ^ geo.seed);
      const uint32_t g = mix_murmur3(key[u] + kStepAdd);
      for (int j = 0; j < geo.k; ++j) {
        const uint32_t p = position(geo, h, g, j);
        atomicOr(r + (p >> 5), 1u << (p & 31u));
      }
    }
  }
  __syncthreads();
  uint32_t* out = words + (size_t)row0 * geo.wpb;
  for (int w = threadIdx.x; w < size; w += kTileThreads) {
    const uint32_t v = tile[w];
    if (v) out[w] |= v;
  }
}

// Whether row `r` (device or shared memory) holds key (h, g)'s k bits: up to
// `first` (<= kLoadBits) hashes every word is loaded before any is tested,
// so the loads of one row do not wait on each other; above, one bit at a
// time, stopping at the first that is clear.  The direct query loads first
// (a third faster at 2^28 keys than bit by bit); the tile query, whose
// words are in shared memory, goes bit by bit (a fifth faster there than
// loading first, which also spilled; NVIDIA H100 80GB HBM3 at 700 W,
// tools/probe_cops_update.py bloom).
__device__ __forceinline__ uint8_t holds_bits(const Geometry& geo,
                                              const uint32_t* r, uint32_t h,
                                              uint32_t g, int first) {
  if (geo.k > first) {
    for (int j = 0; j < geo.k; ++j) {
      const uint32_t p = position(geo, h, g, j);
      if (!((r[p >> 5] >> (p & 31u)) & 1u)) return 0;
    }
    return 1;
  }
  uint32_t word[kLoadBits], pos[kLoadBits];
#pragma unroll
  for (int j = 0; j < kLoadBits; ++j) {
    if (j < geo.k) {
      pos[j] = position(geo, h, g, j);
      word[j] = r[pos[j] >> 5];
    }
  }
  uint32_t all = 1u;
#pragma unroll
  for (int j = 0; j < kLoadBits; ++j)
    if (j < geo.k) all &= word[j] >> (pos[j] & 31u);
  return (uint8_t)(all & 1u);
}

// The direct query: one thread per key, in batch order, every word of the
// key's bits loaded before any is tested.  (Two or four keys a thread were
// no faster on an H100: tools/probe_cops_update.py bloom.)
__global__ void __launch_bounds__(kThreads)
query_kernel(const uint32_t* __restrict__ words,
             const uint32_t* __restrict__ keys,
             const int32_t* __restrict__ planes, uint8_t* __restrict__ out,
             long long n, Geometry geo) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  size_t row;
  uint32_t h, g;
  out[i] = locate(geo, keys[i], planes, i, &row, &h, &g)
               ? holds_bits(geo, words + row, h, g, kLoadBits) : 0;
}

// Step 5 of the partitioned query: block t loads tile t of the filter into
// shared memory with 16-byte loads (the words of its first and last 16
// bytes outside the tile too), then tests the bits of the tile's keys (the
// second scratch's begin[t] .. begin[t + 1]) there and writes each answer
// at the key's slot, coalesced.  A tile without keys is not loaded.
__global__ void __launch_bounds__(kTileThreads)
tile_query_kernel(const uint32_t* __restrict__ words,
                  const uint32_t* __restrict__ keys,
                  const int32_t* __restrict__ planes, Geometry geo, Parts pt,
                  const int* __restrict__ counts,
                  uint8_t* __restrict__ answers) {
  extern __shared__ uint4 tile_chunks[];
  const int* begin = pt.begin(const_cast<int*>(counts));
  const int lo = begin[blockIdx.x], hi = begin[blockIdx.x + 1];
  if (lo == hi) return;
  const uint32_t row0 = blockIdx.x * pt.rows_per_tile;
  const int size = (int)(min(pt.rows_per_tile, geo.rows - row0)) * geo.wpb;
  const uint32_t* from = words + (size_t)row0 * geo.wpb;
  const int mis = (int)(((uintptr_t)from >> 2) & 3u);  // words before it
  const uint4* src = reinterpret_cast<const uint4*>(from - mis);
  for (int c = threadIdx.x; c < (size + mis + 3) >> 2; c += kTileThreads)
    tile_chunks[c] = __ldg(src + c);
  __syncthreads();
  const uint32_t* tile = reinterpret_cast<const uint32_t*>(tile_chunks) + mis;
  for (int i0 = lo + threadIdx.x; i0 < hi; i0 += kUnroll * kTileThreads) {
    uint32_t key[kUnroll];  // loaded together, then tested
    int plane[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kTileThreads;
      if (i < hi) {
        key[u] = keys[i];
        plane[u] = planes ? planes[i] : 0;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kTileThreads;
      if (i >= hi) break;
      const uint32_t row = (uint32_t)plane[u] * geo.num_blocks
                           + geo.blocks.mod(mix_murmur3(key[u] ^ geo.seed));
      answers[i] = holds_bits(geo, tile + (size_t)(row - row0) * geo.wpb,
                              mix_xxhash(key[u] ^ geo.seed),
                              mix_murmur3(key[u] + kStepAdd), 0);
    }
  }
}

// Steps 6 and 7 of the partitioned query: out[i] = from[slots[i]] (0 where
// the slot is -1) for i < *count (null: n), 4 answers a thread: a 16-byte
// load of their slots and one 4-byte store.  Consecutive slots point into
// the runs of one scatter block, so the reads of `from` are runs too.
// `slots` 16-byte and `out` 4-byte aligned.
__global__ void __launch_bounds__(kThreads)
gather_kernel(const uint8_t* __restrict__ from,
              const int32_t* __restrict__ slots, uint8_t* __restrict__ out,
              long long n, const int* __restrict__ count) {
  const long long m = count ? *count : n;
  const long long i = ((long long)blockIdx.x * kThreads + threadIdx.x) * 4;
  if (i >= m) return;
  if (i + 4 <= m) {
    const int4 s = *reinterpret_cast<const int4*>(slots + i);
    *reinterpret_cast<uchar4*>(out + i) = make_uchar4(
        s.x >= 0 ? from[s.x] : 0, s.y >= 0 ? from[s.y] : 0,
        s.z >= 0 ? from[s.z] : 0, s.w >= 0 ? from[s.w] : 0);
    return;
  }
  for (long long j = i; j < m; ++j)
    out[j] = slots[j] >= 0 ? from[slots[j]] : 0;
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
  geo->rows = (uint32_t)((long long)planes * num_blocks);
  geo->pow2 = (geo->bits & (geo->bits - 1u)) == 0u;
  geo->blocks = make_divider(num_blocks);
  return true;
}

// The partitioned paths' cut (see bloom_insert_partitioned), checked: false
// when it does not cover the filter's rows or exceeds the kernels' limits.
bool make_parts(Parts* pt, long long n, int planes, unsigned num_blocks,
                int wpb, unsigned rows_per_tile, int tiles,
                int tiles_per_range, int ranges) {
  const long long rows = (long long)planes * num_blocks;
  if (n >= (1LL << 31) || rows > 0xFFFFFFFFLL || rows_per_tile < 1 ||
      (long long)rows_per_tile * wpb > kTileWords || tiles < 1 ||
      tiles > kMaxTiles || (long long)tiles * rows_per_tile < rows ||
      (long long)(tiles - 1) * rows_per_tile >= rows ||
      tiles_per_range < 1 || tiles_per_range > kMaxLocal || ranges < 1 ||
      ranges > kMaxLocal || (long long)ranges * tiles_per_range < tiles ||
      (long long)(ranges - 1) * tiles_per_range >= tiles)
    return false;
  *pt = Parts{rows_per_tile, tiles, tiles_per_range, ranges,
              make_divider(rows_per_tile),
              make_divider(rows_per_tile * (uint32_t)tiles_per_range)};
  return true;
}

// Steps 1-4 of both partitioned paths on stream `s`: the kept keys sorted
// by tile into `s2_keys` (and planes), through `s1_*` by range; with
// slots (the query), each key's first-scratch slot at s1_slots[i] and each
// first-scratch key's second-scratch slot at s2_slots[j].
void sort_by_tile(const uint32_t* keys, const uint8_t* mask,
                  const int32_t* planes, long long n, const Geometry& geo,
                  const Parts& pt, int* counts, uint32_t* s1_keys,
                  int32_t* s1_planes, uint32_t* s2_keys, int32_t* s2_planes,
                  int32_t* s1_slots, int32_t* s2_slots, cudaStream_t s) {
  int dev, sms;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncSetAttribute(histogram_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kMaxTiles * (int)sizeof(int));
  const long long hist_blocks = (n + kScanThreads - 1) / kScanThreads;
  const unsigned key_tiles = (unsigned)((n + kTileKeys - 1) / kTileKeys);
  int per_sm = 1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, histogram_kernel, kScanThreads, pt.tiles * sizeof(int));
  histogram_kernel<<<(unsigned)min(hist_blocks,
                                   (long long)sms * max(per_sm, 1)),
                     kScanThreads, pt.tiles * sizeof(int), s>>>(
      keys, mask, planes, n, geo, pt, counts);
  scan_kernel<<<1, kScanThreads, 0, s>>>(pt, counts);
  // the insert's scatters carry no slot code, which slowed them (by range
  // and by tile 1.439 + 1.678 ms against 1.377 + 1.462 at 2^28 keys on an
  // NVIDIA H100 80GB HBM3 at 700 W)
  auto first = s1_slots ? scatter_kernel<false, true>
                        : scatter_kernel<false, false>;
  auto second = s1_slots ? scatter_kernel<true, true>
                         : scatter_kernel<true, false>;
  first<<<key_tiles, kThreads, 0, s>>>(
      keys, mask, planes, n, geo, pt, counts, s1_keys, s1_planes, s1_slots);
  second<<<key_tiles + pt.ranges, kThreads, 0, s>>>(
      s1_keys, nullptr, planes ? s1_planes : nullptr, n, geo, pt, counts,
      s2_keys, s2_planes, s2_slots);
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

// The partitioned insert (see the header): the filter's planes * num_blocks
// flat rows (< 2^32) cut into `tiles` tiles of `rows_per_tile` rows
// (rows_per_tile * wpb <= 16384 words, tiles <= 32768) and those into
// `ranges` ranges of `tiles_per_range` tiles (both <= 1024); n < 2^31.
// Scratch: `s1_keys`, `s2_keys` (n,) u32 and, with `plane`, `s1_planes`,
// `s2_planes` (n,) int32; `counts` (3 * tiles + 3 * ranges + 3,) int32,
// zero.  Launches the five steps on `stream`; otherwise as bloom_insert.
extern "C" int bloom_insert_partitioned(
    void* words, const void* keys, const void* mask, const void* plane,
    long long n, int planes, unsigned num_blocks, int wpb, int k,
    unsigned seed, unsigned rows_per_tile, int tiles, int tiles_per_range,
    int ranges, void* s1_keys, void* s1_planes, void* s2_keys,
    void* s2_planes, void* counts, void* stream) {
  Geometry geo;
  Parts pt;
  if (!make_geometry(&geo, n, planes, num_blocks, wpb, k, seed) ||
      !make_parts(&pt, n, planes, num_blocks, wpb, rows_per_tile, tiles,
                  tiles_per_range, ranges) ||
      (plane && (!s1_planes || !s2_planes)))
    return (int)cudaErrorInvalidValue;
  if (n == 0 || k == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const int32_t* p = (const int32_t*)plane;
  sort_by_tile((const uint32_t*)keys, (const uint8_t*)mask, p, n, geo, pt,
               (int*)counts, (uint32_t*)s1_keys, (int32_t*)s1_planes,
               (uint32_t*)s2_keys, (int32_t*)s2_planes, nullptr, nullptr, s);
  cudaFuncSetAttribute(tile_insert_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kTileWords * (int)sizeof(uint32_t));
  tile_insert_kernel<<<tiles, kTileThreads,
                       rows_per_tile * wpb * sizeof(uint32_t), s>>>(
      (uint32_t*)words, (const uint32_t*)s2_keys,
      p ? (const int32_t*)s2_planes : nullptr, geo, pt, (const int*)counts);
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

// The partitioned query (see the header), cut as bloom_insert_partitioned.
// Scratch: as the insert's, and `s1_slots`, `s2_slots` (n,) int32 and
// `s1_answers`, `s2_answers` (n,) uint8, each 16-byte aligned; `out` 4-byte
// aligned.
// Launches the seven steps on `stream`; otherwise as bloom_query.
extern "C" int bloom_query_partitioned(
    const void* words, const void* keys, const void* plane, void* out,
    long long n, int planes, unsigned num_blocks, int wpb, int k,
    unsigned seed, unsigned rows_per_tile, int tiles, int tiles_per_range,
    int ranges, void* s1_keys, void* s1_planes, void* s2_keys,
    void* s2_planes, void* s1_slots, void* s2_slots, void* s1_answers,
    void* s2_answers, void* counts, void* stream) {
  Geometry geo;
  Parts pt;
  if (!make_geometry(&geo, n, planes, num_blocks, wpb, k, seed) ||
      !make_parts(&pt, n, planes, num_blocks, wpb, rows_per_tile, tiles,
                  tiles_per_range, ranges) ||
      (plane && (!s1_planes || !s2_planes)) ||
      (((uintptr_t)s1_slots | (uintptr_t)s2_slots | (uintptr_t)s1_answers |
        (uintptr_t)s2_answers) & 15u) || ((uintptr_t)out & 3u))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const int32_t* p = (const int32_t*)plane;
  int* c = (int*)counts;
  sort_by_tile((const uint32_t*)keys, nullptr, p, n, geo, pt, c,
               (uint32_t*)s1_keys, (int32_t*)s1_planes, (uint32_t*)s2_keys,
               (int32_t*)s2_planes, (int32_t*)s1_slots, (int32_t*)s2_slots,
               s);
  const int tile_bytes = (int)((rows_per_tile * wpb + 8) * sizeof(uint32_t));
  cudaFuncSetAttribute(tile_query_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (kTileWords + 8) * (int)sizeof(uint32_t));
  tile_query_kernel<<<tiles, kTileThreads, tile_bytes, s>>>(
      (const uint32_t*)words, (const uint32_t*)s2_keys,
      p ? (const int32_t*)s2_planes : nullptr, geo, pt, c,
      (uint8_t*)s2_answers);
  const unsigned quads = (unsigned)((n + 4 * kThreads - 1) / (4 * kThreads));
  gather_kernel<<<quads, kThreads, 0, s>>>(
      (const uint8_t*)s2_answers, (const int32_t*)s2_slots,
      (uint8_t*)s1_answers, n, pt.begin(c) + tiles);
  gather_kernel<<<quads, kThreads, 0, s>>>(
      (const uint8_t*)s1_answers, (const int32_t*)s1_slots, (uint8_t*)out,
      n, nullptr);
  return (int)cudaGetLastError();
}
