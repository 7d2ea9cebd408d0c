// COPS kernels of the SOA store for Hopper (sm_90a), hand-written CUDA.
//
// Replaces (src/repro/kernels/cops/kernel.py):
//   cops_lookup    <- _lookup_kernel (l.789, via lookup_call l.830)
//   cops_insert    <- _insert_kernel (l.75, via insert_call l.162), single-value
//                     mode (claim-or-update)
//   cops_append    <- _insert_kernel, multi_value=True mode (l.103-118): claim
//                     the lowest free lane of the first window that has one
//   cops_retrieve  <- _retrieve_kernel (l.334, via retrieve_multi_call l.384):
//                     the multi-value walk, counts and the slot arena
//
// The store is the SOA layout: a key plane and a value plane, each (p, W)
// u32, row-major; one row is one probe window.  A walk starts at row
// h1(k) = murmur3(k ^ seed) mod p and steps by g(k) = xxhash(k ^ seed2)
// mod (p - 1) + 1 ("cops", double hashing over rows) or by 1 ("linear"),
// for at most max_probes windows (the coverage-clamped budget).  The hash
// arithmetic is bit-identical to repro_torch/core/hashing.py.
//
// What bounds these kernels: each probe window is one random read of
// W * 4 bytes of the key plane (at W = 32 one 128-byte line; at W = 1 one
// 32-byte sector for 4 useful bytes), and each hit one random 32-byte
// sector of the value plane (or of the two arena planes).  A walk's
// windows depend on each other, so the work is latency- and sector-bound,
// far from the card's 3.35 TB/s on sequential streams.  The design:
//   - one group of G = min(W, 32) lanes walks one key: at W = 32 a warp
//     reads a whole window in one coalesced 128-byte load, and votes on it
//     with __ballot_sync + __ffs (the paper's cooperative-group probe,
//     §IV-B.2); for W < 32 a warp walks 32 / W keys at once, each group
//     voting on its own lanes; for W > 32 a warp walks the window in
//     32-lane chunks;
//   - thousands of independent walks are in flight per SM (8 warps per
//     block, no shared memory) to hide the latency of the dependent loads;
//   - the key, value and status streams are read and written once,
//     coalesced, by lane 0 of each group.
//
// The insert takes DISTINCT keys (the caller's dedup front end): a key
// absent at the start of the batch can then be claimed by no other group,
// so the walk's absence proof holds while other groups write.  A walk
// remembers the earliest EMPTY / TOMBSTONE lane it sees and runs on to a
// match (UPDATED: store the value) or a window holding an EMPTY; it then
// claims the remembered slot with atomicCAS(slot, observed sentinel, k).
// A lost CAS re-reads the same window and takes its next free lane, and
// goes on to the following rows of the walk only when that window has none
// left, so no free slot still before the key's first EMPTY window is
// skipped.  Every live key thus stays at or before the first EMPTY window
// of its walk (EMPTY is never re-created).  Slot placement may differ from
// the single-writer reference; the live key->value map does not.  Key
// reads in the insert are volatile so a re-read sees other groups' claims.
//
// The append has no dedup front end: every pair is its own claimer, and
// the consecutive duplicates of a multi-value batch start on the same row
// and race for its lanes.  It walks to the first window that holds an
// EMPTY or TOMBSTONE lane and claims through the same CAS loop.  A window
// seen full stays full (claims never free a slot), so a pair never lands
// past the first EMPTY window of its walk, and a FULL pair's whole walk
// was full.
//
// The retrieve walk is read-only on the store and takes distinct
// representatives (the torch dedup front end), so its arena stamps never
// collide and its output is bit-exact against the sequential reference.
// Each window's match ballot gives the count (__popc) and each matching
// lane's rank in walk order (__popc of the ballot's lower lanes); the walk
// stops after the first window holding an EMPTY (tombstones do not stop
// it) or at the budget.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kEmpty = 0xFFFFFFFFu;
constexpr uint32_t kTombstone = 0xFFFFFFFEu;
constexpr int kInserted = 0;
constexpr int kUpdated = 1;
constexpr int kFull = 2;
constexpr int kThreads = 256;

struct Walk {
  uint32_t num_rows;
  uint32_t window;
  uint32_t seed;
  uint32_t seed2;
  int linear;
  long long max_probes;
};

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

__device__ __forceinline__ uint32_t first_row(const Walk& w, uint32_t k) {
  return mix_murmur3(k ^ w.seed) % w.num_rows;
}

__device__ __forceinline__ uint32_t row_step(const Walk& w, uint32_t k) {
  return w.linear ? 1u : mix_xxhash(k ^ w.seed2) % (w.num_rows - 1u) + 1u;
}

// row + step < 2p <= 2^32 because p < 2^31
__device__ __forceinline__ uint32_t next_row(const Walk& w, uint32_t row,
                                             uint32_t step) {
  return (row + step) % w.num_rows;
}

// The G lanes of a warp that walk one key together.
struct Group {
  unsigned mask;  // the group's lanes within the warp
  int base;       // the group's first lane
  int lane;       // this thread's lane within the group
  int size;       // G

  __device__ unsigned ballot(bool pred) const {
    unsigned b = __ballot_sync(mask, pred);
    return size == 32 ? b : (b >> base) & ((1u << size) - 1u);
  }
  __device__ int broadcast(int v) const {
    return __shfl_sync(mask, v, 0, size);
  }
};

__device__ __forceinline__ Group make_group(int size) {
  Group g;
  const int lane = threadIdx.x & 31;
  g.size = size;
  g.base = lane - lane % size;
  g.lane = lane % size;
  g.mask = size == 32 ? 0xFFFFFFFFu : ((1u << size) - 1u) << g.base;
  return g;
}

__device__ __forceinline__ uint32_t load_volatile(const uint32_t* p) {
  return *reinterpret_cast<const volatile uint32_t*>(p);
}

// Lowest EMPTY / TOMBSTONE lane of a window as it stands now, -1 if none.
__device__ int free_lane(const uint32_t* tk, const Walk& w, uint32_t row,
                         const Group& g) {
  const uint32_t* win = tk + (size_t)row * w.window;
  for (uint32_t c = 0; c < w.window; c += g.size) {
    const uint32_t x = load_volatile(win + c + g.lane);
    const unsigned fb = g.ballot(x == kEmpty || x == kTombstone);
    if (fb) return (int)c + __ffs(fb) - 1;
  }
  return -1;
}

// From `row` (walk attempt `attempt`) on, the first window of the walk that
// holds an EMPTY / TOMBSTONE lane: returns that lane and leaves `row` and
// `attempt` there; -1 when the budget runs out first.
__device__ int next_free(const uint32_t* tk, const Walk& w, const Group& g,
                         uint32_t& row, long long& attempt, uint32_t step) {
  int lane = free_lane(tk, w, row, g);
  while (lane < 0 && ++attempt < w.max_probes) {
    row = next_row(w, row, step);
    lane = free_lane(tk, w, row, g);
  }
  return lane;
}

// Claim `lane` of `row` for k with atomicCAS(slot, observed sentinel, k) and
// write v beside it.  A lost CAS re-reads the same window first, then the
// following rows of the walk.  False when the budget runs out.
__device__ bool claim(uint32_t* tk, uint32_t* tv, const Walk& w,
                      const Group& g, uint32_t row, int lane,
                      long long attempt, uint32_t step, uint32_t k,
                      uint32_t v) {
  while (lane >= 0) {
    int won = 0;
    if (g.lane == 0) {
      uint32_t* slot = tk + (size_t)row * w.window + lane;
      const uint32_t seen = load_volatile(slot);
      if (seen == kEmpty || seen == kTombstone)
        won = atomicCAS(slot, seen, k) == seen;
    }
    if (g.broadcast(won)) {
      if (g.lane == 0) tv[(size_t)row * w.window + lane] = v;
      return true;
    }
    lane = next_free(tk, w, g, row, attempt, step);
  }
  return false;
}

__global__ void __launch_bounds__(kThreads)
insert_kernel(uint32_t* __restrict__ tk, uint32_t* __restrict__ tv,
              const uint32_t* __restrict__ keys,
              const uint32_t* __restrict__ vals, int* __restrict__ status,
              long long n, Walk w) {
  const int G = w.window < 32 ? (int)w.window : 32;
  const long long q = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (q >= n) return;  // whole groups leave together
  const Group g = make_group(G);
  const uint32_t k = keys[q];
  const uint32_t step = row_step(w, k);
  uint32_t row = first_row(w, k);

  int st = kFull;
  uint32_t cand_row = 0;
  int cand_lane = -1;
  long long cand_attempt = 0;
  for (long long attempt = 0; attempt < w.max_probes; ++attempt) {
    const uint32_t* win = tk + (size_t)row * w.window;
    int mlane = -1, flane = -1;
    bool any_empty = false;
    for (uint32_t c = 0; c < w.window; c += G) {
      const uint32_t x = load_volatile(win + c + g.lane);
      const unsigned mb = g.ballot(x == k);
      const unsigned eb = g.ballot(x == kEmpty);
      const unsigned fb = eb | g.ballot(x == kTombstone);
      if (mlane < 0 && mb) mlane = (int)c + __ffs(mb) - 1;
      if (flane < 0 && fb) flane = (int)c + __ffs(fb) - 1;
      any_empty |= eb != 0;
    }
    if (mlane >= 0) {
      if (g.lane == 0) tv[(size_t)row * w.window + mlane] = vals[q];
      st = kUpdated;
      break;
    }
    if (cand_lane < 0 && flane >= 0) {
      cand_row = row;
      cand_lane = flane;
      cand_attempt = attempt;
    }
    if (any_empty) break;
    row = next_row(w, row, step);
  }

  if (st != kUpdated && cand_lane >= 0 &&
      claim(tk, tv, w, g, cand_row, cand_lane, cand_attempt, step, k,
            vals[q]))
    st = kInserted;
  if (g.lane == 0) status[q] = st;
}

__global__ void __launch_bounds__(kThreads)
append_kernel(uint32_t* __restrict__ tk, uint32_t* __restrict__ tv,
              const uint32_t* __restrict__ keys,
              const uint32_t* __restrict__ vals, int* __restrict__ status,
              long long n, Walk w) {
  const int G = w.window < 32 ? (int)w.window : 32;
  const long long q = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (q >= n) return;
  const Group g = make_group(G);
  const uint32_t k = keys[q];
  const uint32_t step = row_step(w, k);
  uint32_t row = first_row(w, k);
  long long attempt = 0;
  const int lane = next_free(tk, w, g, row, attempt, step);
  const bool ok = claim(tk, tv, w, g, row, lane, attempt, step, k, vals[q]);
  if (g.lane == 0) status[q] = ok ? kInserted : kFull;
}

__global__ void __launch_bounds__(kThreads)
lookup_kernel(const uint32_t* __restrict__ tk, const uint32_t* __restrict__ tv,
              const uint32_t* __restrict__ keys, uint32_t* __restrict__ out,
              bool* __restrict__ found, long long* __restrict__ slot_out,
              long long n, Walk w) {
  const int G = w.window < 32 ? (int)w.window : 32;
  const long long q = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (q >= n) return;
  const Group g = make_group(G);
  const uint32_t k = keys[q];
  const uint32_t step = row_step(w, k);
  uint32_t row = first_row(w, k);

  long long hit = -1;
  for (long long attempt = 0; attempt < w.max_probes; ++attempt) {
    const uint32_t* win = tk + (size_t)row * w.window;
    int mlane = -1;
    bool any_empty = false;
    for (uint32_t c = 0; c < w.window; c += G) {
      const uint32_t x = __ldg(win + c + g.lane);
      const unsigned mb = g.ballot(x == k);
      if (mlane < 0 && mb) mlane = (int)c + __ffs(mb) - 1;
      any_empty |= g.ballot(x == kEmpty) != 0;
    }
    if (mlane >= 0) {
      hit = (long long)row * w.window + mlane;
      break;
    }
    if (any_empty) break;
    row = next_row(w, row, step);
  }
  if (g.lane == 0) {
    out[q] = hit >= 0 ? __ldg(tv + hit) : 0u;
    found[q] = hit >= 0;
    if (slot_out) slot_out[q] = hit;
  }
}

// counts[q]: the matches of key q's walk (0 where !active[q]); with
// `qa` / `ra` (both or neither), each matching slot gets qa = q and ra = the
// match's rank in walk order.
__global__ void __launch_bounds__(kThreads)
retrieve_kernel(const uint32_t* __restrict__ tk,
                const uint32_t* __restrict__ keys,
                const bool* __restrict__ active, int* __restrict__ counts,
                int* __restrict__ qa, int* __restrict__ ra, long long n,
                Walk w) {
  const int G = w.window < 32 ? (int)w.window : 32;
  const long long q = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (q >= n) return;
  const Group g = make_group(G);
  int seen = 0;
  if (active[q]) {
    const uint32_t k = keys[q];
    const uint32_t step = row_step(w, k);
    const unsigned below = (1u << g.lane) - 1u;  // lanes before this one
    uint32_t row = first_row(w, k);
    for (long long attempt = 0; attempt < w.max_probes; ++attempt) {
      const size_t base = (size_t)row * w.window;
      bool any_empty = false;
      for (uint32_t c = 0; c < w.window; c += G) {
        const uint32_t x = __ldg(tk + base + c + g.lane);
        const unsigned mb = g.ballot(x == k);
        if (qa && x == k) {
          qa[base + c + g.lane] = (int)q;
          ra[base + c + g.lane] = seen + __popc(mb & below);
        }
        seen += __popc(mb);
        any_empty |= g.ballot(x == kEmpty) != 0;
      }
      if (any_empty) break;
      row = next_row(w, row, step);
    }
  }
  if (g.lane == 0) counts[q] = seen;
}

Walk make_walk(unsigned num_rows, int window, unsigned seed, int linear,
               long long max_probes) {
  Walk w;
  w.num_rows = num_rows;
  w.window = (uint32_t)window;
  w.seed = seed;
  w.seed2 = seed * 0x9E3779B1u;  // the step mixer's seed, mod 2^32
  w.linear = linear;
  w.max_probes = max_probes;
  return w;
}

unsigned blocks_for(long long n, int window) {
  const long long threads = n * (window < 32 ? window : 32);
  return (unsigned)((threads + kThreads - 1) / kThreads);
}

}  // namespace

// Every entry point launches on `stream`, allocate nothing, do not
// synchronise, and return cudaGetLastError() of the launch (0 = success).
extern "C" int cops_insert(void* table_keys, void* table_values,
                           const void* keys, const void* values, void* status,
                           long long n, unsigned num_rows, int window,
                           unsigned seed, int linear, long long max_probes,
                           void* stream) {
  if (n <= 0) return 0;
  insert_kernel<<<blocks_for(n, window), kThreads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)table_keys, (uint32_t*)table_values, (const uint32_t*)keys,
      (const uint32_t*)values, (int*)status, n,
      make_walk(num_rows, window, seed, linear, max_probes));
  return (int)cudaGetLastError();
}

extern "C" int cops_lookup(const void* table_keys, const void* table_values,
                           const void* keys, void* values, void* found,
                           void* slots, long long n, unsigned num_rows,
                           int window, unsigned seed, int linear,
                           long long max_probes, void* stream) {
  if (n <= 0) return 0;
  lookup_kernel<<<blocks_for(n, window), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)table_keys, (const uint32_t*)table_values,
      (const uint32_t*)keys, (uint32_t*)values, (bool*)found,
      (long long*)slots, n,
      make_walk(num_rows, window, seed, linear, max_probes));
  return (int)cudaGetLastError();
}

extern "C" int cops_append(void* table_keys, void* table_values,
                           const void* keys, const void* values, void* status,
                           long long n, unsigned num_rows, int window,
                           unsigned seed, int linear, long long max_probes,
                           void* stream) {
  if (n <= 0) return 0;
  append_kernel<<<blocks_for(n, window), kThreads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)table_keys, (uint32_t*)table_values, (const uint32_t*)keys,
      (const uint32_t*)values, (int*)status, n,
      make_walk(num_rows, window, seed, linear, max_probes));
  return (int)cudaGetLastError();
}

// `qarena` / `rank_arena` are both null (counts only) or both (p * W,)
// planes that the caller filled with n and 0.
extern "C" int cops_retrieve(const void* table_keys, const void* keys,
                             const void* active, void* counts, void* qarena,
                             void* rank_arena, long long n, unsigned num_rows,
                             int window, unsigned seed, int linear,
                             long long max_probes, void* stream) {
  if (n <= 0) return 0;
  retrieve_kernel<<<blocks_for(n, window), kThreads, 0,
                    (cudaStream_t)stream>>>(
      (const uint32_t*)table_keys, (const uint32_t*)keys,
      (const bool*)active, (int*)counts, (int*)qarena, (int*)rank_arena, n,
      make_walk(num_rows, window, seed, linear, max_probes));
  return (int)cudaGetLastError();
}
