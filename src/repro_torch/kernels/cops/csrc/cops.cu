// COPS kernels of the SOA store for Hopper (sm_90a), hand-written CUDA.
//
// Replaces (src/repro/kernels/cops/kernel.py):
//   cops_lookup      <- _lookup_kernel (l.789, via lookup_call l.830)
//   cops_insert      <- _insert_kernel (l.75, via insert_call l.162),
//                       single-value mode (claim-or-update)
//   cops_append      <- _insert_kernel, multi_value=True mode (l.103-118):
//                       claim the lowest free lane of the first window that
//                       has one
//   cops_retrieve    <- _retrieve_kernel (l.334, via retrieve_multi_call
//                       l.384): the multi-value walk, counts and slot arena
//   cops_insert64    <- _insert64_kernel (l.518, via insert64_call l.603),
//                       single-value mode, for two-plane keys
//   cops_append64    <- _insert64_kernel, multi_value=True mode (l.547-561)
//   cops_lookup64    <- _lookup64_kernel (l.629, via lookup64_call l.672)
//   cops_retrieve64  <- _retrieve64_kernel (l.694, via retrieve_multi64_call
//                       l.756)
//   cops_bucket_walk <- _bucket_walk_kernel (l.435, via bucket_walk_call
//                       l.485): the bucket list's chain walk over its pool
//   cops_update      <- _update_kernel (l.203, via update_call l.289): the
//                       group-by read-modify-write (and the counting table's
//                       saturating count), 1-word keys
//   cops_update64    <- the same for two-plane keys (the Pallas package runs
//                       those on its vectorized engine, kernel.py has no
//                       two-plane update tile)
//
// The store is the SOA layout: KW key planes and a value plane, each (p, W)
// u32, row-major; one row is one probe window.  Two-plane keys (u64 and
// two-column composite keys) keep the low word in plane 0, which holds the
// EMPTY / TOMBSTONE sentinels, and the high word in plane 1; their key
// batches are (n, 2) u32.  A walk hashes the key's probe word: the key for
// one plane, combine_planes(hi, lo) for two.  It starts at row
// h1 = murmur3(word ^ seed) mod p and steps by g = xxhash(word ^ seed2)
// mod (p - 1) + 1 ("cops", double hashing over rows) or by 1 ("linear"),
// for at most max_probes windows (the coverage-clamped budget).  The hash
// arithmetic is bit-identical to repro_torch/core/hashing.py.  A key
// matches a lane when every plane holds its word.
//
// What bounds these kernels: each probe window is one random read of
// W * 4 bytes of plane 0 (at W = 32 one 128-byte line; at W = 1 one 32-byte
// sector for 4 useful bytes), and each hit one random 32-byte sector of the
// value plane (or of the two arena planes).  A two-plane walk reads plane 1
// only in the lanes whose plane 0 holds the key's low word: one 32-byte
// sector per such window, not a second line.  A walk's windows depend on
// each other, so the work is latency- and sector-bound, far from the card's
// 3.35 TB/s on sequential streams.  The design:
//   - a warp reads 32 lanes of a window in one coalesced load (at W = 32
//     the whole 128-byte line) and votes on it with __ballot_sync + __ffs
//     (the paper's cooperative-group probe, §IV-B.2); W > 32 is walked in
//     32-lane chunks;
//   - at W < 32 one group of G = W lanes walks one key, so a warp walks
//     32 / W keys at once, each group voting on its own lanes;
//   - at W >= 32 the upsert, the update, both two-plane passes
//     (walk_kernel) and the lookup (lookup_walk_kernel) walk K = kWalkKeys
//     keys a warp, the retrieve (retrieve_walk_kernel) K = kRetrieveKeys:
//     lane j holds key j's walk state, and each round (window_round, one
//     function for all of them) reads the current chunk of every walking
//     key's window, all K loads issued before the first ballot, so a warp
//     keeps K chains of dependent reads in flight where it kept one.  The
//     append (one run of equal keys, below) still walks one run a warp
//     there;
//   - thousands of walks are in flight per SM (8 warps per block, no
//     shared memory) to hide the latency of the dependent loads;
//   - the key, value and status streams are read and written once,
//     coalesced, by lane 0 of each group (the K-key walks: lane j for key
//     j; the append: by every lane).
//
// The u32 insert takes DISTINCT keys (the caller's dedup front end): a key
// absent at the start of the batch can then be claimed by no other group,
// so the walk's absence proof holds while other groups write.  A walk
// remembers the earliest EMPTY / TOMBSTONE lane it sees and runs on to a
// match (UPDATED: store the value) or a window holding an EMPTY; it then
// claims the remembered slot with atomicCAS(slot, observed sentinel, k):
// walk_kernel CASes from its K lanes at once, each against the sentinel
// its window read saw, with no second read of the slot (upsert_kernel, at
// W < 32, re-reads the slot first).  A lost CAS is walked on by the whole
// warp (group): it re-reads the same window and takes its next free lane, and
// goes on to the following rows of the walk only when that window has none
// left, so no free slot still before the key's first EMPTY window is
// skipped.  Every live key thus stays at or before the first EMPTY window
// of its walk (EMPTY is never re-created).  Slot placement may differ from
// the single-writer reference; the live key->value map does not.  Key
// reads in the insert are volatile so a re-read sees other groups' claims.
//
// The two-plane insert cannot test a match in the walk that claims.  A
// claim publishes plane 0 with the CAS and plane 1 only after it, and the
// planes lie apart (SOA), so no single CAS covers both.  A group walking
// key X = (lo a, hi h) would match a slot that another group has just
// claimed for Y = (lo a, hi c) but not yet finished, whenever the slot's
// plane 1 still holds h: 0xFFFFFFFF in a fresh EMPTY slot, 0xFFFFFFFE in a
// reused TOMBSTONE (plane 1 has no sentinel restriction, so a user key may
// hold either).  X would overwrite Y's value, report UPDATED, and be lost.
// So cops_insert64 runs two passes over the DISTINCT keys:
//   1. the match walk: read-only on the key planes as they were before
//      the batch (the lookup walks the same rounds and reads the value
//      where this pass writes it), it writes the value of every key found
//      and marks it UPDATED;
//   2. the claim walk of the keys not found: it reads only
//      plane 0, for free lanes, and claims the lowest free lane of the
//      first window that has one with the CAS on plane 0, then writes
//      plane 1 and the value.
// No key is tested against a slot that another group may still be
// writing: pass 1 ends before pass 2 starts (one stream), and pass 2 tests
// no match.  A key absent before the batch stays absent from everyone
// else's view (the keys are distinct), and the first window holding a free
// lane is the earliest candidate at or before the key's first EMPTY
// window, so pass 2 lands where the one-pass walk would.  On an empty store
// the wrapper skips pass 1.  At W >= 32 both passes are walk_kernel, K keys
// a warp: pass 1 reads the K keys' plane-0 windows together and the 32-byte
// plane-1 sector only in the lanes whose plane 0 holds a key's low word;
// pass 2 skips the keys pass 1 found, reads the others' windows together,
// stops each key at the first window holding a free lane, and CASes from
// K lanes at once; a winner writes plane 1 after its CAS, then the value.
// At W < 32 they are match_kernel and claim_kernel, one key a group.
//
// The read-modify-write (cops_update, cops_update64) folds every live row
// of a batch into the value planes: fold_p(old, operand_p) per value plane
// p (add, min, max or the counting table's saturating add, all on u32).
// The torch front end picks one representative per distinct key (the
// group's first live element) and maps every other live row to it
// (rest_rep).  The update combines each group's rows first and then walks
// each group once, in two launches:
//   1. the combine (combine_kernel): acc[r], an (n_reps, V) scratch that
//      the wrapper fills with each op's identity, takes the fold of the
//      operands of the rows that rest_rep maps to r, one atomic per row
//      and plane (atomicAdd, atomicMin, atomicMax on unsigned words; an
//      atomicCAS loop for the saturating add).  Up to kSharedGroups
//      groups, each block folds into a dense copy of acc in shared
//      memory, indexed by rest_rep, and when its rows are done adds each
//      entry that is not the identity to acc with one global atomic per
//      plane; a few blocks per SM stride over the rows, so that flush
//      stays small.  Above it, every row's atomics go to acc in device
//      memory, both planes of a group in one 8-byte entry: one random
//      sector per row.  A warp whose 32 rows all belong to one group (a
//      batch of one key, or sorted by key) folds them first with
//      __reduce_{add,min,max}_sync (the saturating add: the exact sum of
//      two 16-bit halves, saturated) and applies one atomic per plane, so
//      one group's rows do not queue on one word.  Other warps do not
//      combine: __match_any_sync on every warp's rows made the shared
//      combine 8x slower on the card (tools/probe_cops_update.py), and at
//      random keys the lanes of a warp seldom share a group.
//   2. the walk, over the representatives (the two-plane insert's two
//      passes for two-plane keys, the 1-word upsert's walk for 1-word
//      keys; at W >= 32 both walk_kernel): a match folds fold(operand, acc)
//      into the slot and a claim writes fold(claimv, acc) (`Values::load`).
// This is exact: add, min and max on u32, and the saturating add on
// unsigned words, are associative and commutative, so folding a group's
// combined rows in once equals folding each row in turn, in any order.  A
// FULL representative writes nothing, and its rows with it.  The walk's
// keys are distinct, so one group writes each slot.  Walking the batch
// undeduplicated would save the front end, but then which duplicate
// reports INSERTED would follow the race, not the batch order; the
// statuses fan out to the batch in torch.  The value planes, and what a
// walk writes into them, are a `Values` descriptor, a template over the
// plane count and store-or-fold: the upsert and its two-plane claim pass
// store (one plane, or none for a hash set), the update folds into one or
// two planes.
// What bounds the update: the rows' streams (rest_rep and the operands,
// 12 bytes a row at V = 2), which the combine reads at the streaming rate
// while the groups fit in shared memory; above kSharedGroups, one random
// 32-byte sector of acc read and written per row (acc exceeds the 50 MB L2
// from ~6M groups).  Then the walk, as for the insert: per representative
// its windows, one sector per value plane written on a claim or read and
// written on a match, and its entry of acc.  A walk's windows depend on
// each other, so one walk per warp leaves the card's memory system mostly
// idle (a few thousand dependent reads in flight); walk_kernel keeps K of
// them in flight per warp (see the design above).
//
// The append (cops_append, cops_append64) has no dedup front end, and a
// multi-value batch holds its duplicates in runs (Fig. 7 appends each key
// r times in a row).  Were every pair its own claimer, a key's r copies
// would start on the same row and race for its lanes: each re-reads the
// line after every lost CAS, about r(r+1)/2 reads and CAS rounds for r
// slots, all on one line.  So a group of G = min(W, 32) lanes owns G
// consecutive pairs of the batch (lane l pair l), loads them coalesced,
// and finds the runs of equal adjacent keys with one ballot (on both
// planes: two-plane keys sharing their low word must not merge).  It
// walks each run once, from the key's first row with its step, and at
// each window:
//   - reads it (volatile) and ballots its EMPTY / TOMBSTONE lanes;
//   - the run's m remaining pairs take the lowest min(m, free) of them,
//     each chosen lane CASing its own slot (observed sentinel -> k0) at
//     once;
//   - a second ballot gives the winners; the run's next pairs go to them
//     in lane order, so a run meeting no other key fills lanes in batch
//     order, as the sequential reference does;
//   - each winner writes plane 1 (KW == 2) after its CAS, then the value;
//   - lanes lost to another group are re-read: the walk leaves a window
//     only when it holds no free lane.
// A window seen full stays full (claims never free a slot), so a pair
// never lands past the first EMPTY window of its walk, and the pairs a run
// could not place before the budget ran out (FULL) had a full walk.  The
// append tests no match, so plane 1 written after the claim is never read
// half-published.  Runs split at the group's edges, and duplicates that
// are not adjacent form runs of their own: they race through the CAS as
// separate claimers, correct but not faster.  A run costs one walk where
// it cost r, and its r claims one round of reads and CASes where they
// cost about r(r+1)/2.
//
// The retrieve walk is read-only on the store and takes distinct
// representatives (the torch dedup front end), so its arena stamps never
// collide and its output is bit-exact against the sequential reference.
// Each chunk's match ballot gives the count (__popc) and each matching
// lane's rank in walk order (the query's count before the chunk + __popc of
// the ballot's lower lanes), so chunk 0's matches rank before chunk 1's and
// ranks run on across windows; the walk stops after the first window
// holding an EMPTY (tombstones do not stop it) or at the budget, which it
// does not clamp (a row a walk comes back to is counted again).  At W >= 32
// it is retrieve_walk_kernel, kRetrieveKeys queries a warp through
// window_round, whose per-chunk hook hands it each ballot; at W < 32
// retrieve_kernel, a group of W lanes a query.
//
// The bucket walk is the bucket list's retrieval (paper Fig. 4): a key's
// values lie in a chain of buckets in a u32 value pool, and its handle
// (pre-probed by the caller) gives the tail bucket's pool address, the
// tail's index j and the key's value count.  Bucket j > 0 starts with a
// link slot holding the previous bucket's address; its values follow.  A
// walk goes from the tail down to bucket 0 and stamps each value slot of
// the pool-sized arenas with qa = the query's batch index and ra = the
// value's head-first rank cum[j] + i; only the valid slots of the tail are
// written, so the arenas need no padding (the Pallas tile writes whole
// 128-slot chunks).  Distinct queries own disjoint chains, so the stamps
// never collide and the output is deterministic.  What bounds it: the
// stamps (8 bytes per value) and one dependent 4-byte link read per bucket
// after the tail, which serialises a walk.  So bucket_walk_kernel walks
// K = kBucketKeys chains a warp, lane j holding query j's chain (its pool
// address, bucket index and count): each round every walking lane issues
// its link read before any lane stamps, so K dependent chains' reads are
// in flight a warp; then the warp stamps the round's buckets packed over
// its 32 lanes, value t of the round by lane t % 32, so a store writes 32
// slots of a few buckets however small each is.  A warp walks until its
// longest chain ends.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kEmpty = 0xFFFFFFFFu;
constexpr uint32_t kTombstone = 0xFFFFFFFEu;
constexpr int kInserted = 0;
constexpr int kUpdated = 1;
constexpr int kFull = 2;
constexpr int kThreads = 256;
// value ops, 4 bits per value plane in Values::ops (ops.py: FOLD_OPS)
constexpr int kAdd = 0;
constexpr int kMin = 1;
constexpr int kMax = 2;
constexpr int kSatAdd = 3;
// The update's combine keeps acc in shared memory up to this many groups
// (R; see the header): 224 KiB at two value planes, the most that one
// block's 227 KB hold in round figures.  On the card the shared combine
// beat the one into device memory at every count of groups where both
// apply, by 4x at 2^14 (tools/probe_cops_update.py measures it).
constexpr int kSharedGroups = 28672;
// ... with at most this many blocks per SM, each loading this many rows a
// thread before it folds them
constexpr int kCombineBlocksPerSm = 4;
constexpr int kCombineUnroll = 4;
// keys per warp of every walk_kernel at W >= 32 (K; see the header): of
// 1, 2, 4, 8 and 16 keys, 8 walked the update's 2^25 keys in 55% of the
// time of one and built fig5's u32 table in half of it; 16 was 3% faster
// on the u32 insert and 4% slower on the u64 upsert
// (tools/probe_cops_update.py).
constexpr int kWalkKeys = 8;
// keys per warp of the retrieve walk at W >= 32: a retrieve walks each
// query to its first window holding an EMPTY, longer and more varied walks
// than a lookup's, and a warp walks until its longest walk ends; of 1, 2,
// 4, 8 and 16 keys, 4 walked fig7 wc-oa's 2^25 queries collecting in 9%
// (u32) and 7% (u64) less time than 8 (tools/probe_cops_update.py).
constexpr int kRetrieveKeys = 4;
// chains per warp of the bucket walk: of 4, 8, 16 and 32, 8 walked
// wc-bl-1's 2^25 queries 2% slower than 4 and fig8's classify 4% faster
// (NVIDIA H100 80GB HBM3, 700.00 W; tools/probe_cops_update.py walk)
constexpr int kBucketKeys = 8;
constexpr unsigned kAll = 0xFFFFFFFFu;  // every lane of a warp
// walk_kernel's outcomes besides a lane to claim (none: -1): the walk
// ended at its key; the lane walks no key
constexpr int kMatched = -2;
constexpr int kIdle = -3;

struct Walk {
  uint32_t num_rows;
  uint32_t window;
  uint32_t seed;
  uint32_t seed2;
  int linear;
  long long max_probes;
  size_t plane;  // words per key plane: num_rows * window
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

// hashing.combine_planes: the probe word of a two-plane key
__device__ __forceinline__ uint32_t combine_planes(uint32_t hi, uint32_t lo) {
  const uint32_t h = mix_murmur3(lo);
  return h ^ (mix_murmur3(hi) + 0x9E3779B9u + (h << 6) + (h >> 2));
}

// A key of the batch: its plane words and the probe word a walk hashes.
struct Key {
  uint32_t k0;    // plane 0 (the low word)
  uint32_t k1;    // plane 1 (KW == 2 only)
  uint32_t word;  // probe word
};

template <int KW>
__device__ __forceinline__ Key load_key(const uint32_t* keys, long long q) {
  Key k;
  if (KW == 1) {
    k.k0 = k.word = keys[q];
    k.k1 = 0;
  } else {
    const uint2 kk = reinterpret_cast<const uint2*>(keys)[q];
    k.k0 = kk.x;
    k.k1 = kk.y;
    k.word = combine_planes(k.k1, k.k0);
  }
  return k;
}

// Does the lane at flat slot `at`, whose plane 0 holds x, hold key k?
// Plane 1 is read only where plane 0 matches.  Read-only walks only.
template <int KW>
__device__ __forceinline__ bool holds(const uint32_t* tk, const Walk& w,
                                      size_t at, uint32_t x, const Key& k) {
  return x == k.k0 && (KW == 1 || __ldg(tk + w.plane + at) == k.k1);
}

__device__ __forceinline__ uint32_t first_row(const Walk& w, uint32_t word) {
  return mix_murmur3(word ^ w.seed) % w.num_rows;
}

__device__ __forceinline__ uint32_t row_step(const Walk& w, uint32_t word) {
  return w.linear ? 1u : mix_xxhash(word ^ w.seed2) % (w.num_rows - 1u) + 1u;
}

// row + step < 2p <= 2^32 because p < 2^31
__device__ __forceinline__ uint32_t next_row(const Walk& w, uint32_t row,
                                             uint32_t step) {
  return (row + step) % w.num_rows;
}

__device__ __forceinline__ uint32_t fold(int op, uint32_t a, uint32_t b) {
  switch (op) {
    case kAdd: return a + b;
    case kMin: return a < b ? a : b;
    case kMax: return a > b ? a : b;
    case kSatAdd: {
      const uint32_t s = a + b;
      return s < a ? 0xFFFFFFFFu : s;
    }
    default: return b;
  }
}

__device__ __forceinline__ uint32_t load_volatile(const uint32_t* p) {
  return *reinterpret_cast<const volatile uint32_t*>(p);
}

// A batch element's value words: the operands folded in on a match, the
// words written on a claim.
template <int V>
struct Row {
  uint32_t operand[V > 0 ? V : 1];
  uint32_t claimv[V > 0 ? V : 1];
};

// The V value planes of a store (V = 0, 1 or 2) and what a kernel writes
// into them for a batch element at flat slot `at`: on a match plane p
// becomes fold(op_p, old, operand[p]) (FOLD) or operand[p] (a store), on a
// claim it takes claimv[p]; the update's combined rows acc[p] are folded
// into both when the Row is loaded.  V and FOLD are compile-time, so the
// upserts compile as they would with one value plane written in place.
// Written by one lane per key.  A kernel loads a Row where it needs
// it (after the match, or just before the CAS, whose latency hides the
// load): a Row held across the walk costs registers the walk needs.
template <int V, bool FOLD>
struct Values {
  uint32_t* tv;              // plane 0 of V (p, W) planes
  size_t plane;              // words per plane: num_rows * window
  int ops;                   // op of plane p in bits 4p .. 4p + 3 (FOLD)
  const uint32_t* operand;   // (n, V)
  const uint32_t* claimv;    // (n, V)
  const uint32_t* acc;       // (n, V) combined rows (FOLD; null: none)

  __device__ Row<V> load(long long q) const {
    Row<V> r;
#pragma unroll
    for (int p = 0; p < V; ++p) {
      r.operand[p] = operand[q * V + p];
      r.claimv[p] = FOLD ? claimv[q * V + p] : r.operand[p];
      if (FOLD && acc) {
        const int op = (ops >> (4 * p)) & 15;
        const uint32_t a = acc[q * V + p];
        r.operand[p] = fold(op, r.operand[p], a);
        r.claimv[p] = fold(op, r.claimv[p], a);
      }
    }
    return r;
  }
  __device__ void matched(const Row<V>& r, size_t at) const {
#pragma unroll
    for (int p = 0; p < V; ++p) {
      uint32_t* v = tv + p * plane + at;
      *v = FOLD ? fold((ops >> (4 * p)) & 15, *v, r.operand[p])
                : r.operand[p];
    }
  }
  __device__ void claimed(const Row<V>& r, size_t at) const {
#pragma unroll
    for (int p = 0; p < V; ++p) tv[p * plane + at] = r.claimv[p];
  }
};

// fold(op, *at, x) as one atomic read-modify-write
__device__ __forceinline__ void atomic_fold(int op, uint32_t* at, uint32_t x) {
  switch (op) {
    case kAdd: atomicAdd(at, x); break;
    case kMin: atomicMin(at, x); break;
    case kMax: atomicMax(at, x); break;
    default: {  // kSatAdd
      uint32_t seen = load_volatile(at), old;
      while (seen != 0xFFFFFFFFu &&
             (old = atomicCAS(at, seen, fold(kSatAdd, seen, x))) != seen)
        seen = old;
    }
  }
}

__device__ __forceinline__ uint32_t identity(int op) {
  return op == kMin ? 0xFFFFFFFFu : 0u;
}

// fold(op) of x over the lanes of `peers`, which all call it with the same
// mask and get the result
__device__ __forceinline__ uint32_t warp_fold(int op, unsigned peers,
                                              uint32_t x) {
  switch (op) {
    case kAdd: return __reduce_add_sync(peers, x);
    case kMin: return __reduce_min_sync(peers, x);
    case kMax: return __reduce_max_sync(peers, x);
    default: {  // kSatAdd: the exact sum of two 16-bit halves, saturated
      const unsigned long long s =
          ((unsigned long long)__reduce_add_sync(peers, x >> 16) << 16) +
          __reduce_add_sync(peers, x & 0xFFFFu);
      return s > 0xFFFFFFFFull ? 0xFFFFFFFFu : (uint32_t)s;
    }
  }
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

__device__ __forceinline__ int group_size(const Walk& w) {
  return w.window < 32 ? (int)w.window : 32;
}

// The probe length (PLEN) of a walk that spent its whole budget: the
// budget, which a walk clamped to num_rows reports too, since every further
// window of its cycle is one it has read.  A walk that stopped at attempt a
// (a match, a window holding an EMPTY) examined a + 1 windows.  int32, as
// the plain version's counter.
__device__ __forceinline__ int spent_length(const Walk& w) {
  return (int)(w.max_probes < 0            ? 0
               : w.max_probes < 0x7FFFFFFF ? w.max_probes
                                           : 0x7FFFFFFF);
}

// The read-only walk of key k: its flat slot (row * W + lane), or -1 when
// the walk reaches a window holding an EMPTY, or the budget, first.  With
// PLEN, *windows takes the windows the walk examined (spent_length).
template <int KW, bool PLEN = false>
__device__ long long find(const uint32_t* tk, const Walk& w, const Group& g,
                          const Key& k, int* windows = nullptr) {
  const uint32_t step = row_step(w, k.word);
  uint32_t row = first_row(w, k.word);
  long long attempt = 0;
  for (; attempt < w.max_probes; ++attempt) {
    const size_t base = (size_t)row * w.window;
    int mlane = -1;
    bool any_empty = false;
    for (uint32_t c = 0; c < w.window; c += g.size) {
      const size_t at = base + c + g.lane;
      const uint32_t x = __ldg(tk + at);
      const unsigned mb = g.ballot(holds<KW>(tk, w, at, x, k));
      if (mlane < 0 && mb) mlane = (int)c + __ffs(mb) - 1;
      any_empty |= g.ballot(x == kEmpty) != 0;
    }
    if (mlane >= 0) {
      if (PLEN) *windows = (int)(attempt + 1);
      return (long long)base + mlane;
    }
    if (any_empty) {
      if (PLEN) *windows = (int)(attempt + 1);
      return -1;
    }
    row = next_row(w, row, step);
  }
  if (PLEN) *windows = spent_length(w);
  return -1;
}

// Lowest EMPTY / TOMBSTONE lane of a window of plane 0 as it stands now,
// -1 if none.
__device__ __forceinline__ int free_lane(const uint32_t* tk, const Walk& w,
                                         uint32_t row, const Group& g) {
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
__device__ __forceinline__ int next_free(const uint32_t* tk, const Walk& w,
                                         const Group& g, uint32_t& row,
                                         long long& attempt, uint32_t step) {
  int lane = free_lane(tk, w, row, g);
  while (lane < 0 && ++attempt < w.max_probes) {
    row = next_row(w, row, step);
    lane = free_lane(tk, w, row, g);
  }
  return lane;
}

// Claim `lane` of `row` for the key (k0, k1) with atomicCAS(plane-0 slot,
// observed sentinel, k0), then write plane 1 (KW == 2) beside it.  A lost
// CAS re-reads the same window first, then the following rows of the walk.
// Returns the flat slot claimed (the same in every lane of the group), or
// -1 when the budget runs out; the caller writes the values.
template <int KW>
__device__ __forceinline__ long long claim(uint32_t* tk, const Walk& w,
                                           const Group& g, uint32_t row,
                                           int lane, long long attempt,
                                           uint32_t step, uint32_t k0,
                                           uint32_t k1) {
  while (lane >= 0) {
    const size_t at = (size_t)row * w.window + lane;
    int won = 0;
    if (g.lane == 0) {
      const uint32_t seen = load_volatile(tk + at);
      if (seen == kEmpty || seen == kTombstone)
        won = atomicCAS(tk + at, seen, k0) == seen;
    }
    if (g.broadcast(won)) {
      if (KW == 2 && g.lane == 0) tk[w.plane + at] = k1;
      return (long long)at;
    }
    lane = next_free(tk, w, g, row, attempt, step);
  }
  return -1;
}

// The u32 single-value upsert in one walk (see the header), and the
// read-modify-write at W < 32: a match folds into the slot's values, a
// claim writes the claim value.
template <int V, bool FOLD>
__global__ void upsert_kernel(uint32_t* __restrict__ tk,
                              Values<V, FOLD> vals,
                              const uint32_t* __restrict__ keys,
                              int* __restrict__ status, long long n, Walk w) {
  const int G = group_size(w);
  const long long q = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (q >= n) return;  // whole groups leave together
  const Group g = make_group(G);
  const Key k = load_key<1>(keys, q);
  const uint32_t step = row_step(w, k.word);
  uint32_t row = first_row(w, k.word);

  int st = kFull;
  long long at = -1;
  uint32_t cand_row = 0;
  int cand_lane = -1;
  long long cand_attempt = 0;
  for (long long attempt = 0; attempt < w.max_probes; ++attempt) {
    const uint32_t* win = tk + (size_t)row * w.window;
    int mlane = -1, flane = -1;
    bool any_empty = false;
    for (uint32_t c = 0; c < w.window; c += G) {
      const uint32_t x = load_volatile(win + c + g.lane);
      const unsigned mb = g.ballot(x == k.k0);
      const unsigned eb = g.ballot(x == kEmpty);
      const unsigned fb = eb | g.ballot(x == kTombstone);
      if (mlane < 0 && mb) mlane = (int)c + __ffs(mb) - 1;
      if (flane < 0 && fb) flane = (int)c + __ffs(fb) - 1;
      any_empty |= eb != 0;
    }
    if (mlane >= 0) {
      at = (long long)row * w.window + mlane;
      if (g.lane == 0) vals.matched(vals.load(q), (size_t)at);
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

  if (st != kUpdated && cand_lane >= 0) {
    const Row<V> r = vals.load(q);
    at = claim<1>(tk, w, g, cand_row, cand_lane, cand_attempt, step, k.k0,
                   k.k1);
    if (at >= 0) {
      if (g.lane == 0) vals.claimed(r, (size_t)at);
      st = kInserted;
    }
  }
  if (g.lane == 0) status[q] = st;
}

// Pass 1 of the two-plane upsert and update: write (or fold into) the
// values of every key found and mark it UPDATED (FULL, for now, where not
// found).
template <int KW, int V, bool FOLD>
__global__ void __launch_bounds__(kThreads)
match_kernel(const uint32_t* __restrict__ tk, Values<V, FOLD> vals,
             const uint32_t* __restrict__ keys, int* __restrict__ status,
             long long n, Walk w) {
  const int G = group_size(w);
  const long long q = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (q >= n) return;
  const Group g = make_group(G);
  const long long hit = find<KW>(tk, w, g, load_key<KW>(keys, q));
  if (g.lane == 0) {
    if (hit >= 0) vals.matched(vals.load(q), (size_t)hit);
    status[q] = hit >= 0 ? kUpdated : kFull;
  }
}

// Pass 2 of the two-plane upsert and update, the claim walk of each
// DISTINCT key (`after_match`: skip the keys that pass 1 marked UPDATED).
template <int KW, int V, bool FOLD>
__global__ void __launch_bounds__(kThreads)
claim_kernel(uint32_t* __restrict__ tk, Values<V, FOLD> vals,
             const uint32_t* __restrict__ keys, int* __restrict__ status,
             long long n, Walk w, int after_match) {
  const int G = group_size(w);
  const long long q = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (q >= n || (after_match && status[q] == kUpdated)) return;
  const Group g = make_group(G);
  const Key k = load_key<KW>(keys, q);
  const uint32_t step = row_step(w, k.word);
  uint32_t row = first_row(w, k.word);
  long long attempt = 0;
  const int lane = next_free(tk, w, g, row, attempt, step);
  const Row<V> r = vals.load(q);
  const long long at =
      claim<KW>(tk, w, g, row, lane, attempt, step, k.k0, k.k1);
  if (g.lane == 0) {
    if (at >= 0) vals.claimed(r, (size_t)at);
    status[q] = at >= 0 ? kInserted : kFull;
  }
}

// Place the run of pairs s .. s + m - 1 of the group's chunk, all of key
// (k0, k1) with probe word `word`, in one walk (see the header); lane l
// holds the value `v` of pair l.  Returns how many of the run's pairs
// landed: the first ones, in batch order; the rest are FULL.
template <int KW>
__device__ int place_run(uint32_t* tk, uint32_t* tv, const Walk& w,
                         const Group& g, uint32_t k0, uint32_t k1,
                         uint32_t word, int s, int m, uint32_t v) {
  const unsigned below = (1u << g.lane) - 1u;  // lanes before this one
  const uint32_t step = row_step(w, word);
  uint32_t row = first_row(w, word);
  long long attempt = 0;
  int done = 0;
  while (done < m) {
    const size_t base = (size_t)row * w.window;
    // the first G-lane chunk of the window holding a free lane
    uint32_t c = 0, x = 0;
    unsigned fb = 0;
    for (; c < w.window; c += g.size) {
      x = load_volatile(tk + base + c + g.lane);
      fb = g.ballot(x == kEmpty || x == kTombstone);
      if (fb) break;
    }
    bool full = fb == 0;
    if (!full) {
      const size_t at = base + c + g.lane;
      const bool take = ((fb >> g.lane) & 1u) && __popc(fb & below) < m - done;
      const bool won = take && atomicCAS(tk + at, x, k0) == x;
      const unsigned wb = g.ballot(won);
      const int pair = s + done + __popc(wb & below);
      const uint32_t val = __shfl_sync(g.mask, v, won ? pair : g.lane, g.size);
      if (won) {
        if (KW == 2) tk[w.plane + at] = k1;
        tv[at] = val;
      }
      done += __popc(wb);
      // every free lane of a one-chunk window is now taken: it is full
      full = wb == fb && w.window == (uint32_t)g.size;
    }
    if (full && done < m) {
      if (++attempt >= w.max_probes) break;
      row = next_row(w, row, step);
    }
  }
  return done;
}

// The append: each group of G lanes places the G pairs of its chunk, run by
// run (see the header).
template <int KW>
__global__ void __launch_bounds__(kThreads)
append_kernel(uint32_t* __restrict__ tk, uint32_t* __restrict__ tv,
              const uint32_t* __restrict__ keys,
              const uint32_t* __restrict__ values, int* __restrict__ status,
              long long n, Walk w) {
  const int G = group_size(w);
  const long long chunk =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G * G;
  if (chunk >= n) return;  // whole groups leave together
  const Group g = make_group(G);
  const int live = n - chunk < G ? (int)(n - chunk) : G;  // its pairs
  const long long q = chunk + g.lane;
  const bool mine = g.lane < live;
  Key k = {0u, 0u, 0u};
  uint32_t v = 0u;
  if (mine) {
    k = load_key<KW>(keys, q);
    v = values[q];
  }
  // a run starts where the key differs from the pair before, on any plane
  const uint32_t prev0 = __shfl_up_sync(g.mask, k.k0, 1, G);
  const uint32_t prev1 = __shfl_up_sync(g.mask, k.k1, 1, G);
  unsigned starts = g.ballot(
      mine && (g.lane == 0 || prev0 != k.k0 || (KW == 2 && prev1 != k.k1)));
  int st = kFull;
  while (starts) {
    const int s = __ffs(starts) - 1;
    starts &= starts - 1u;
    const int e = starts ? __ffs(starts) - 1 : live;
    const int done = place_run<KW>(
        tk, tv, w, g, __shfl_sync(g.mask, k.k0, s, G),
        __shfl_sync(g.mask, k.k1, s, G), __shfl_sync(g.mask, k.word, s, G),
        s, e - s, v);
    if (g.lane >= s && g.lane < e) st = g.lane - s < done ? kInserted : kFull;
  }
  if (mine) status[q] = st;
}

// Launch 1 of the update (see the header): acc[r] (n_reps, V), filled with
// each op's identity, takes the fold of the operands of the rows that
// rest_rep maps to r (-1: a representative or a masked row, folded
// nowhere).  SHARED: through a dense copy of acc in this block's shared
// memory, added to acc when the block's rows are done.
template <int V, bool SHARED>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const int* __restrict__ rest_rep,
               const uint32_t* __restrict__ operand, uint32_t* acc,
               long long n_rest, int n_reps, int ops) {
  extern __shared__ uint32_t sacc[];
  uint32_t* const into = SHARED ? sacc : acc;
  if (SHARED) {
    for (int i = threadIdx.x; i < n_reps * V; i += blockDim.x)
      sacc[i] = identity((ops >> (4 * (i % V))) & 15);
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const long long tile = (long long)kThreads * kCombineUnroll;
  // base is the same in every thread of a block: whole warps stay in step
  for (long long base = (long long)blockIdx.x * tile; base < n_rest;
       base += (long long)gridDim.x * tile) {
    int r[kCombineUnroll];
    uint32_t x[kCombineUnroll][V];
#pragma unroll
    for (int u = 0; u < kCombineUnroll; ++u) {
      const long long i = base + u * kThreads + threadIdx.x;
      const bool in = i < n_rest;
      r[u] = in ? __ldg(rest_rep + i) : -1;
#pragma unroll
      for (int p = 0; p < V; ++p)
        x[u][p] = in ? __ldg(operand + i * V + p) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kCombineUnroll; ++u) {
      // a warp whose rows all belong to one group folds them first
      const int r0 = __shfl_sync(0xFFFFFFFFu, r[u], 0);
      const bool one = __all_sync(0xFFFFFFFFu, r[u] == r0);
#pragma unroll
      for (int p = 0; p < V; ++p) {
        const int op = (ops >> (4 * p)) & 15;
        if (one) {
          const uint32_t v = warp_fold(op, 0xFFFFFFFFu, x[u][p]);
          if (lane == 0 && r0 >= 0)
            atomic_fold(op, into + (size_t)r0 * V + p, v);
        } else if (r[u] >= 0) {
          atomic_fold(op, into + (size_t)r[u] * V + p, x[u][p]);
        }
      }
    }
  }
  if (SHARED) {
    __syncthreads();
    for (int i = threadIdx.x; i < n_reps * V; i += blockDim.x) {
      const int op = (ops >> (4 * (i % V))) & 15;
      if (sacc[i] != identity(op)) atomic_fold(op, acc + i, sacc[i]);
    }
  }
}

// walk_kernel's key of this lane (lane j of each warp walks the warp's
// key j), read anew from the special registers wherever it is used, so
// that no register holds a 64-bit index across the walk.
template <int K>
__device__ __forceinline__ long long key_index() {
  unsigned tid, cta;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(tid));
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(cta));
  return ((long long)cta * kThreads + tid) / 32 * K + (tid & 31);
}

// The probe word of the key (k0, k1): load_key's, recomputed where a walk
// needs it (its first row, a step), so that no register holds it between.
template <int KW>
__device__ __forceinline__ uint32_t probe_word(uint32_t k0, uint32_t k1) {
  return KW == 1 ? k0 : combine_planes(k1, k0);
}

// The row of walk attempt `a` of the key with probe word `word`: `a` steps
// from its first row.
__device__ __forceinline__ uint32_t row_at(const Walk& w, uint32_t word,
                                           int a) {
  return (uint32_t)(((unsigned long long)first_row(w, word) +
                     (unsigned long long)a * row_step(w, word)) %
                    w.num_rows);
}

// What one round of a K-key walk (below) tells lane j of key j's window.
struct Round {
  int mlane;       // the lowest lane holding the key (MATCH), -1 if none
  int flane;       // the lowest EMPTY / TOMBSTONE lane (CLAIM), -1 if none
  bool ftomb;      // ... which held a TOMBSTONE
  bool any_empty;  // the window holds an EMPTY
};

// window_round's hook on each chunk's match ballot: none (the walks that
// keep only the lowest matching lane)
struct NoBallots {
  __device__ __forceinline__ void operator()(int, uint32_t, unsigned) const {}
};

// One round of the walks at W >= 32 (walk_kernel, lookup_walk_kernel,
// retrieve_walk_kernel): lane j < K holds key j (its words k0, k1 and its
// current row), and `act` has bit j set while key j walks (the same in
// every lane).  The round reads the window of every walking key, chunk by
// 32-lane chunk, all K loads of a chunk issued before the first ballot,
// so that a warp keeps K chains of dependent reads in flight.  A
// two-plane MATCH reads plane 1 only in the lanes whose plane 0 holds the
// key's low word (a 32-byte sector).  The whole window is read before any
// verdict, so a match in a later chunk wins over an EMPTY in an earlier
// one, and the lowest matching lane of the window is the one returned.
// With MATCH, every lane calls on_ballot(j, c, mb) with chunk c's whole
// match ballot mb of each walking key j, chunk by chunk (the retrieve
// counts and stamps there; the other walks pass NoBallots).
template <int KW, int K, bool MATCH, bool CLAIM, class OnBallot = NoBallots>
__device__ __forceinline__ Round window_round(
    const uint32_t* tk, const Walk& w, unsigned act, uint32_t row,
    uint32_t k0, uint32_t k1, OnBallot on_ballot = OnBallot()) {
  const int lane = threadIdx.x & 31;
  Round r = {-1, -1, false, false};
  for (uint32_t c = 0; c < w.window; c += 32) {
    uint32_t x[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const uint32_t rj = __shfl_sync(kAll, row, j);
      if ((act >> j) & 1u) {
        const uint32_t* at = tk + (size_t)rj * w.window + c + lane;
        // the walks that claim nothing read planes no one writes
        x[j] = CLAIM ? load_volatile(at) : __ldg(at);
      }
    }
    // the votes on plane 0, after which x is dead (a two-plane match
    // pass then holds its plane-1 words in its registers instead)
    unsigned hit = 0;  // bit j: this lane holds key j (plane 0 alone)
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (!((act >> j) & 1u)) continue;  // the same in every lane
      if (MATCH) hit |= (unsigned)(x[j] == __shfl_sync(kAll, k0, j)) << j;
      const unsigned eb = __ballot_sync(kAll, x[j] == kEmpty);
      const unsigned fb =
          CLAIM ? eb | __ballot_sync(kAll, x[j] == kTombstone) : 0u;
      if (lane == j) {
        if (r.flane < 0 && fb) {
          const int f = __ffs(fb) - 1;
          r.flane = (int)c + f;
          r.ftomb = !((eb >> f) & 1u);
        }
        r.any_empty |= eb != 0;
      }
    }
    if (MATCH && KW == 2) {
      // plane 1 only where plane 0 holds the key's low word: a sector
      uint32_t y[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if (!((act >> j) & 1u)) continue;
        const uint32_t rj = __shfl_sync(kAll, row, j);
        if ((hit >> j) & 1u)
          y[j] = __ldg(tk + w.plane + (size_t)rj * w.window + c + lane);
      }
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if (!((act >> j) & 1u)) continue;
        const uint32_t kj = __shfl_sync(kAll, k1, j);
        if (((hit >> j) & 1u) && y[j] != kj) hit &= ~(1u << j);
      }
    }
    if (MATCH) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if (!((act >> j) & 1u)) continue;
        const unsigned mb = __ballot_sync(kAll, (hit >> j) & 1u);
        on_ballot(j, c, mb);
        if (lane == j && r.mlane < 0 && mb)
          r.mlane = (int)c + __ffs(mb) - 1;
      }
    }
  }
  return r;
}

// The walk at W >= 32 (see the header): a warp walks K keys of the batch,
// lane j < K holding key j's walk, a window_round for each window.
// With MATCH a key leaves its walk at a lane holding it (store or fold its
// values: UPDATED) or after a window holding an EMPTY, and with CLAIM as
// well it remembers its earliest free lane on the way; with CLAIM alone
// (the two-plane claim pass, which tests no match) it leaves at the first
// window holding a free lane; any walk ends at the budget.  The claims CAS
// from their K lanes at once against the sentinel the read saw; one that
// loses is walked on by the whole warp (`claim`), the same window first.
// Three walks:
//   <1, V, FOLD, K, true, true>   the 1-word upsert (a store) and update;
//   <2, V, FOLD, K, true, false>  pass 1 of the two-plane upsert and update;
//   <2, V, FOLD, K, false, true>  pass 2: the keys pass 1 did not find
//                                 (`after_match`), or every key.
// A walk holds only what it cannot recompute: its key's words, its row
// and attempt (32 bits: after num_rows windows a walk meets only rows it
// has read, and a claim never frees a lane, so the budget is clamped
// there) and its outcome (`out`: kIdle, kMatched, none (-1) or the lane
// to claim, with the attempt and sentinel it was seen at).  The key's
// index, its probe word, the step and the candidate's row are recomputed
// where needed; few walks take a step (at fig5's load a walk reads 1.046
// windows).  No __launch_bounds__ here or on upsert_kernel:
// under __launch_bounds__(kThreads) ptxas moved values live across the
// walk to local memory to reach a lower register count
// (tools/probe_cops_update.py, variant "bounds").
template <int KW, int V, bool FOLD, int K, bool MATCH, bool CLAIM>
__global__ void walk_kernel(uint32_t* __restrict__ tk, Values<V, FOLD> vals,
                            const uint32_t* __restrict__ keys,
                            int* __restrict__ status, long long n, Walk w,
                            int after_match) {
  static_assert(K >= 1 && K <= 32, "a lane per key");
  static_assert(KW == 1 ? MATCH && CLAIM : MATCH != CLAIM,
                "a two-plane walk that claims tests no match (the header)");
  const int lane = threadIdx.x & 31;
  if (key_index<K>() - lane >= n) return;  // whole warps leave together
  int out = lane < K && key_index<K>() < n ? -1 : kIdle;
  if (!MATCH && after_match && out == -1 &&
      status[key_index<K>()] == kUpdated)
    out = kIdle;
  uint32_t k0 = 0, k1 = 0, row = 0;
  if (out == -1) {
    const Key k = load_key<KW>(keys, key_index<K>());
    k0 = k.k0;
    k1 = k.k1;
    row = first_row(w, k.word);
  }
  const int budget =
      (int)(w.max_probes < (long long)w.num_rows ? w.max_probes
                                                 : w.num_rows);
  int attempt = 0, cand_attempt = 0;
  bool cand_tomb = false;  // the lane to claim held a TOMBSTONE
  bool walking = out == -1;
  unsigned act;
  while ((act = __ballot_sync(kAll, walking)) != 0) {
    const Round r =
        window_round<KW, K, MATCH, CLAIM>(tk, w, act, row, k0, k1);
    if (!walking) continue;
    if (r.mlane >= 0) {
      vals.matched(vals.load(key_index<K>()),
                   (size_t)row * w.window + r.mlane);
      out = kMatched;
      walking = false;
      continue;
    }
    if (out < 0 && r.flane >= 0) {
      out = r.flane;
      cand_attempt = attempt;
      cand_tomb = r.ftomb;
    }
    if ((MATCH ? r.any_empty : out >= 0) || ++attempt >= budget)
      walking = false;
    else
      row = next_row(w, row, row_step(w, probe_word<KW>(k0, k1)));
  }

  bool won = false;
  if constexpr (CLAIM) {
    const bool claiming = out >= 0;
    Row<V> r;
    long long at = -1;
    if (claiming) {
      r = vals.load(key_index<K>());
      // the claim pass stops at the window it claims in; the one-pass
      // walk may have walked past it
      if (MATCH) {
        attempt = cand_attempt;
        row = row_at(w, probe_word<KW>(k0, k1), attempt);
      }
      at = (long long)row * w.window + out;
      const uint32_t seen = cand_tomb ? kTombstone : kEmpty;
      won = atomicCAS(tk + at, seen, k0) == seen;
      if (KW == 2 && won) tk[w.plane + at] = k1;
    }
    unsigned lost = __ballot_sync(kAll, claiming && !won);
    const Group g = make_group(32);
    while (lost) {
      const int j = __ffs(lost) - 1;
      lost &= lost - 1u;
      const uint32_t kj0 = __shfl_sync(kAll, k0, j);
      const uint32_t kj1 = __shfl_sync(kAll, k1, j);
      const uint32_t sj = row_step(w, probe_word<KW>(kj0, kj1));
      uint32_t rj = __shfl_sync(kAll, row, j);
      long long aj = __shfl_sync(kAll, attempt, j);  // the full budget
      // the same window first, then the following rows of the walk
      const int fl = next_free(tk, w, g, rj, aj, sj);
      const long long got = claim<KW>(tk, w, g, rj, fl, aj, sj, kj0, kj1);
      if (lane == j) {
        at = got;
        won = got >= 0;
      }
    }
    if (won) vals.claimed(r, (size_t)at);
  }
  if (out != kIdle)
    status[key_index<K>()] =
        out == kMatched ? kUpdated : won ? kInserted : kFull;
}

// VALUES: read the value of each key found (false: a hash set, no value
// plane; `tv` and `out` are null).  PLEN: write each key's probe length,
// the windows its walk examined (spent_length), to `plen` (else null).
template <int KW, bool VALUES, bool PLEN>
__global__ void __launch_bounds__(kThreads)
lookup_kernel(const uint32_t* __restrict__ tk, const uint32_t* __restrict__ tv,
              const uint32_t* __restrict__ keys, uint32_t* __restrict__ out,
              bool* __restrict__ found, long long* __restrict__ slot_out,
              int* __restrict__ plen, long long n, Walk w) {
  const int G = group_size(w);
  const long long q = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (q >= n) return;
  const Group g = make_group(G);
  int windows = 0;
  const long long hit =
      find<KW, PLEN>(tk, w, g, load_key<KW>(keys, q), &windows);
  if (g.lane == 0) {
    if (VALUES) out[q] = hit >= 0 ? __ldg(tv + hit) : 0u;
    found[q] = hit >= 0;
    if (slot_out) slot_out[q] = hit;
    if (PLEN) plen[q] = windows;
  }
}

// The lookup at W >= 32 (see the header): a warp walks K keys, lane j < K
// holding key j's walk, through the rounds of the two-plane match pass
// (window_round<KW, K, true, false>).  A walk ends at the lowest lane of a
// window holding its key, after a window holding an EMPTY (a TOMBSTONE
// does not stop it), or at the budget, clamped to num_rows as walk_kernel
// clamps it: a read-only walk that has read num_rows windows has read
// every row of its cycle.  Lane j then reads key j's value sector where it
// matched and writes key j's outputs.  VALUES and PLEN as for
// lookup_kernel: a walk that ends at the clamp has read every row of its
// cycle, so it reports the whole budget, as the unclamped walk would.
template <int KW, bool VALUES, int K, bool PLEN>
__global__ void lookup_walk_kernel(const uint32_t* __restrict__ tk,
                                   const uint32_t* __restrict__ tv,
                                   const uint32_t* __restrict__ keys,
                                   uint32_t* __restrict__ out,
                                   bool* __restrict__ found,
                                   long long* __restrict__ slot_out,
                                   int* __restrict__ plen, long long n,
                                   Walk w) {
  static_assert(K >= 1 && K <= 32, "a lane per key");
  const int lane = threadIdx.x & 31;
  if (key_index<K>() - lane >= n) return;  // whole warps leave together
  const bool mine = lane < K && key_index<K>() < n;
  uint32_t k0 = 0, k1 = 0, row = 0;
  if (mine) {
    const Key k = load_key<KW>(keys, key_index<K>());
    k0 = k.k0;
    k1 = k.k1;
    row = first_row(w, k.word);
  }
  const int budget =
      (int)(w.max_probes < (long long)w.num_rows ? w.max_probes
                                                 : w.num_rows);
  int attempt = 0, mlane = -1;
  bool walking = mine && budget > 0;
  unsigned act;
  while ((act = __ballot_sync(kAll, walking)) != 0) {
    const Round r = window_round<KW, K, true, false>(tk, w, act, row, k0, k1);
    if (!walking) continue;
    if (r.mlane >= 0) {
      mlane = r.mlane;
      walking = false;
    } else if (r.any_empty || ++attempt >= budget) {
      walking = false;
    } else {
      row = next_row(w, row, row_step(w, probe_word<KW>(k0, k1)));
    }
  }
  if (mine) {
    const long long q = key_index<K>();
    const long long hit =
        mlane >= 0 ? (long long)row * w.window + mlane : -1;
    if (VALUES) out[q] = hit >= 0 ? __ldg(tv + hit) : 0u;
    found[q] = hit >= 0;
    if (slot_out) slot_out[q] = hit;
    // a walk that stopped did so at attempt < budget; one that spent its
    // budget left attempt at it
    if (PLEN) plen[q] = attempt < budget ? attempt + 1 : spent_length(w);
  }
}

// counts[q]: the matches of key q's walk (0 where !active[q]); with
// `qa` / `ra` (both or neither), each matching slot gets qa = q and ra = the
// match's rank in walk order.
template <int KW>
__global__ void __launch_bounds__(kThreads)
retrieve_kernel(const uint32_t* __restrict__ tk,
                const uint32_t* __restrict__ keys,
                const bool* __restrict__ active, int* __restrict__ counts,
                int* __restrict__ qa, int* __restrict__ ra, long long n,
                Walk w) {
  const int G = group_size(w);
  const long long q = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (q >= n) return;
  const Group g = make_group(G);
  int seen = 0;
  if (active[q]) {
    const Key k = load_key<KW>(keys, q);
    const uint32_t step = row_step(w, k.word);
    const unsigned below = (1u << g.lane) - 1u;  // lanes before this one
    uint32_t row = first_row(w, k.word);
    for (long long attempt = 0; attempt < w.max_probes; ++attempt) {
      const size_t base = (size_t)row * w.window;
      bool any_empty = false;
      for (uint32_t c = 0; c < w.window; c += G) {
        const size_t at = base + c + g.lane;
        const uint32_t x = __ldg(tk + at);
        const bool m = holds<KW>(tk, w, at, x, k);
        const unsigned mb = g.ballot(m);
        if (qa && m) {
          qa[at] = (int)q;
          ra[at] = seen + __popc(mb & below);
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

// The retrieve at W >= 32 (see the header): a warp walks K queries, lane
// j < K holding query j's walk and its count, through the rounds of the
// two-plane match pass (window_round<KW, K, true, false>), whose hook takes
// each chunk's whole match ballot mb of each walking query j: lane j adds
// __popc(mb), and with COLLECT (both arenas given) each lane l set in mb
// stamps its slot with qa = q_j and ra = q_j's count before the chunk (one
// shuffle) + the matching lanes below l.  A walk ends after the first
// window holding an EMPTY or at the budget, which, unlike the match walks',
// is not clamped to num_rows: the retrieve counts and stamps every window
// it reads, so a walk that comes back to a row counts it again, as
// retrieve_walk_plain does; attempts are 64-bit.  Every lane j then writes
// counts[q_j], 0 where !active[q_j].
template <int KW, int K, bool COLLECT>
__global__ void retrieve_walk_kernel(const uint32_t* __restrict__ tk,
                                     const uint32_t* __restrict__ keys,
                                     const bool* __restrict__ active,
                                     int* __restrict__ counts,
                                     int* __restrict__ qa,
                                     int* __restrict__ ra, long long n,
                                     Walk w) {
  static_assert(K >= 1 && K <= 32, "a lane per key");
  const int lane = threadIdx.x & 31;
  if (key_index<K>() - lane >= n) return;  // whole warps leave together
  const bool mine = lane < K && key_index<K>() < n;
  bool walking = mine && w.max_probes > 0 && active[key_index<K>()];
  uint32_t k0 = 0, k1 = 0, row = 0;
  if (walking) {
    const Key k = load_key<KW>(keys, key_index<K>());
    k0 = k.k0;
    k1 = k.k1;
    row = first_row(w, k.word);
  }
  int seen = 0;
  // every lane calls it with the same (j, c, mb)
  const auto tally = [&](int j, uint32_t c, unsigned mb) {
    if (!mb) return;
    if (COLLECT) {
      const int before = __shfl_sync(kAll, seen, j);
      const uint32_t rj = __shfl_sync(kAll, row, j);
      if ((mb >> lane) & 1u) {
        const size_t at = (size_t)rj * w.window + c + lane;
        qa[at] = (int)(key_index<K>() - lane + j);
        ra[at] = before + __popc(mb & ((1u << lane) - 1u));
      }
    }
    if (lane == j) seen += __popc(mb);
  };
  long long attempt = 0;
  unsigned act;
  while ((act = __ballot_sync(kAll, walking)) != 0) {
    const Round r =
        window_round<KW, K, true, false>(tk, w, act, row, k0, k1, tally);
    if (!walking) continue;
    if (r.any_empty || ++attempt >= w.max_probes)
      walking = false;
    else
      row = next_row(w, row, row_step(w, probe_word<KW>(k0, k1)));
  }
  if (mine) counts[key_index<K>()] = seen;
}

// The chain walks of the active queries, K a warp (see the header).
template <int K>
__global__ void __launch_bounds__(kThreads)
bucket_walk_kernel(const uint32_t* __restrict__ pool,
                   const uint32_t* __restrict__ ptr,
                   const int* __restrict__ cnt, const int* __restrict__ bidx,
                   const bool* __restrict__ active,
                   const int* __restrict__ sizes, const int* __restrict__ cum,
                   int* __restrict__ qa, int* __restrict__ ra, long long n) {
  const long long first = ((long long)blockIdx.x * kThreads + threadIdx.x)
                          / 32 * K;
  if (first >= n) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const long long q = first + lane;
  // lane j < K: query j's chain, its handle fields read coalesced
  bool walking = lane < K && q < n && active[q];
  int j = -1, count = 0;
  uint32_t p = 0;
  if (walking) {
    count = cnt[q];
    p = ptr[q];
    j = bidx[q];
    walking = j >= 0;
  }
  while (__ballot_sync(kAll, walking)) {
    int base = 0, valid = 0;
    size_t start = 0;
    uint32_t prev = 0;
    if (walking) {
      if (j > 0) prev = __ldg(pool + p);  // the link, in flight in the stamps
      base = __ldg(cum + j);
      valid = min(count - base, __ldg(sizes + j));  // tail: partial
      start = (size_t)p + (j > 0);                  // after the link
    }
    // the round's values packed over the lanes, 32 a store: value t of the
    // round (in lane order) goes to lane t % 32, which finds its bucket's
    // lane by a binary search over the lanes' first values
    const int mine = max(valid, 0);
    int incl = mine;
#pragma unroll
    for (int d = 1; d < K; d <<= 1) {
      const int y = __shfl_up_sync(kAll, incl, d);
      if (lane >= d) incl += y;
    }
    const int total = __shfl_sync(kAll, incl, K - 1);
    const int excl = incl - mine;
    for (int c = 0; c < total; c += 32) {
      const int t = c + lane;
      int o = 0;  // the last lane whose values start at or before t
#pragma unroll
      for (int d = K / 2; d > 0; d >>= 1)
        if (__shfl_sync(kAll, excl, o + d) <= t) o += d;
      const int i = t - __shfl_sync(kAll, excl, o);
      const size_t s = __shfl_sync(kAll, (unsigned long long)start, o);
      const int b = __shfl_sync(kAll, base, o);
      if (t < total) {
        qa[s + i] = (int)(first + o);
        ra[s + i] = b + i;
      }
    }
    if (walking) {
      p = prev;
      walking = --j >= 0;
    }
  }
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
  w.plane = (size_t)num_rows * (size_t)window;
  return w;
}

unsigned blocks_for(long long n, int window) {
  const long long threads = n * (window < 32 ? window : 32);
  return (unsigned)((threads + kThreads - 1) / kThreads);
}

// blocks of a K-key walk for n keys: a warp per `keys` of them
unsigned walk_blocks(long long n, int keys = kWalkKeys) {
  const long long threads = (n + keys - 1) / keys * 32;
  return (unsigned)((threads + kThreads - 1) / kThreads);
}


// The lookup of n keys: at W >= 32 lookup_walk_kernel, kWalkKeys keys a
// warp; below, lookup_kernel, 32 / W keys a warp.  PLEN: with the probe
// lengths (`plen` not null).
template <int KW, bool VALUES, bool PLEN>
void lookup_launch(const Walk& w, const uint32_t* tk, const uint32_t* tv,
                   const uint32_t* keys, uint32_t* values, bool* found,
                   long long* slots, int* plen, long long n,
                   cudaStream_t stream) {
  if (w.window >= 32)
    lookup_walk_kernel<KW, VALUES, kWalkKeys, PLEN>
        <<<walk_blocks(n), kThreads, 0, stream>>>(tk, tv, keys, values,
                                                  found, slots, plen, n, w);
  else
    lookup_kernel<KW, VALUES, PLEN><<<blocks_for(n, w.window), kThreads, 0,
                                      stream>>>(tk, tv, keys, values, found,
                                                slots, plen, n, w);
}

template <int KW>
int lookup(const void* table_keys, const void* table_values, const void* keys,
           void* values, void* found, void* slots, void* plen, long long n,
           unsigned num_rows, int window, unsigned seed, int linear,
           long long max_probes, void* stream) {
  if (n <= 0) return 0;
  const Walk w = make_walk(num_rows, window, seed, linear, max_probes);
  const auto launch =
      table_values ? (plen ? lookup_launch<KW, true, true>
                           : lookup_launch<KW, true, false>)
                   : (plen ? lookup_launch<KW, false, true>
                           : lookup_launch<KW, false, false>);
  launch(w, (const uint32_t*)table_keys, (const uint32_t*)table_values,
         (const uint32_t*)keys, (uint32_t*)values, (bool*)found,
         (long long*)slots, (int*)plen, n, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// The write-back of a launch: the V value planes at `table_values`, folded
// into (FOLD) or stored, from the (n, V) `operand` and `claimv` batches;
// for the update, the (n_rest,) `rest_rep` and (n_rest, V) `rest_operand`
// rows that launch 1 combines into the (n, V) `acc` scratch, which the walk
// folds in (all null, and n_rest 0, for a batch with no such row).
struct Writes {
  void* table_values;
  int ops;
  const void* operand;
  const void* claimv;
  const void* rest_rep;
  const void* rest_operand;
  void* acc;
  long long n_rest;
};

template <int V, bool FOLD>
Values<V, FOLD> make_values(const Writes& wr, unsigned num_rows, int window) {
  Values<V, FOLD> v;
  v.tv = (uint32_t*)wr.table_values;
  v.plane = (size_t)num_rows * (size_t)window;
  v.ops = wr.ops;
  v.operand = (const uint32_t*)wr.operand;
  v.claimv = (const uint32_t*)wr.claimv;
  v.acc = (const uint32_t*)wr.acc;
  return v;
}

// Launch 1 of the update (see the header) for n representatives: in shared
// memory up to kSharedGroups of them, else into acc directly; a few blocks
// per SM, striding over the rows.
template <int V>
int combine(const Writes& wr, long long n, void* stream) {
  if (wr.n_rest <= 0) return 0;
  const bool shared = n <= kSharedGroups;
  const size_t smem = shared ? (size_t)n * V * sizeof(uint32_t) : 0;
  void (*kernel)(const int*, const uint32_t*, uint32_t*, long long, int,
                 int) = shared ? combine_kernel<V, true>
                               : combine_kernel<V, false>;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const long long tile = (long long)kThreads * kCombineUnroll;
  const long long need = (wr.n_rest + tile - 1) / tile;
  const int per = per_sm < 1 ? 1
                  : per_sm < kCombineBlocksPerSm ? per_sm
                                                 : kCombineBlocksPerSm;
  const long long most = (long long)sms * per;
  kernel<<<(unsigned)(need < most ? need : most), kThreads, smem,
           (cudaStream_t)stream>>>(
      (const int*)wr.rest_rep, (const uint32_t*)wr.rest_operand,
      (uint32_t*)wr.acc, wr.n_rest, shared ? (int)n : 0, wr.ops);
  return (int)cudaGetLastError();
}

// One walk per 1-word key: the upsert (a store) or the update (FOLD); at
// W >= 32 walk_kernel, kWalkKeys keys a warp.
template <int V, bool FOLD>
int upsert(void* table_keys, const Writes& wr, const void* keys,
           void* status, long long n, unsigned num_rows, int window,
           unsigned seed, int linear, long long max_probes, void* stream) {
  const Walk w = make_walk(num_rows, window, seed, linear, max_probes);
  const Values<V, FOLD> vals = make_values<V, FOLD>(wr, num_rows, window);
  if (window >= 32)
    walk_kernel<1, V, FOLD, kWalkKeys, true, true>
        <<<walk_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
            (uint32_t*)table_keys, vals, (const uint32_t*)keys,
            (int*)status, n, w, 0);
  else
    upsert_kernel<V, FOLD><<<blocks_for(n, window), kThreads, 0,
                             (cudaStream_t)stream>>>(
        (uint32_t*)table_keys, vals, (const uint32_t*)keys, (int*)status, n,
        w);
  return (int)cudaGetLastError();
}

// The two passes of the two-plane upsert or update; `match_pass` = 0 runs
// pass 2 alone (the wrappers pass 0 on an empty store, which holds no key
// to find).  At W >= 32 both are walk_kernel, kWalkKeys keys a warp.
template <int KW, int V, bool FOLD>
int two_pass(void* table_keys, const Writes& wr, const void* keys,
             void* status, long long n, unsigned num_rows, int window,
             unsigned seed, int linear, long long max_probes, int match_pass,
             void* stream) {
  const Walk w = make_walk(num_rows, window, seed, linear, max_probes);
  const Values<V, FOLD> vals = make_values<V, FOLD>(wr, num_rows, window);
  uint32_t* const tk = (uint32_t*)table_keys;
  const uint32_t* const kk = (const uint32_t*)keys;
  int* const out = (int*)status;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool many = window >= 32;
  if (match_pass) {
    if (many)
      walk_kernel<KW, V, FOLD, kWalkKeys, true, false>
          <<<walk_blocks(n), kThreads, 0, s>>>(tk, vals, kk, out, n, w, 0);
    else
      match_kernel<KW, V, FOLD><<<blocks_for(n, window), kThreads, 0, s>>>(
          tk, vals, kk, out, n, w);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (many)
    walk_kernel<KW, V, FOLD, kWalkKeys, false, true>
        <<<walk_blocks(n), kThreads, 0, s>>>(tk, vals, kk, out, n, w,
                                             match_pass);
  else
    claim_kernel<KW, V, FOLD><<<blocks_for(n, window), kThreads, 0, s>>>(
        tk, vals, kk, out, n, w, match_pass);
  return (int)cudaGetLastError();
}

// The walk of V value planes: of 1-word keys in one pass (`upsert`), of
// two-plane keys in two (`two_pass`; `match_pass` is read only there); for
// the update (FOLD), after launch 1, the combine of the rows.
template <int KW, int V, bool FOLD>
int walk(void* table_keys, const Writes& wr, const void* keys, void* status,
         long long n, unsigned num_rows, int window, unsigned seed,
         int linear, long long max_probes, int match_pass, void* stream) {
  if constexpr (FOLD) {
    const int rc = combine<V>(wr, n, stream);
    if (rc != 0) return rc;
  }
  if constexpr (KW == 1)
    return upsert<V, FOLD>(table_keys, wr, keys, status, n, num_rows, window,
                           seed, linear, max_probes, stream);
  else
    return two_pass<KW, V, FOLD>(table_keys, wr, keys, status, n, num_rows,
                                 window, seed, linear, max_probes,
                                 match_pass > 0, stream);
}

// The instantiation for `value_words` planes (0 only with a null
// `table_values`: a hash set, which the update does not take) and FOLD.
template <int KW, bool FOLD>
int launch(void* table_keys, const Writes& wr, int value_words,
           const void* keys, void* status, long long n, unsigned num_rows,
           int window, unsigned seed, int linear, long long max_probes,
           int match_pass, void* stream) {
  if (n <= 0) return 0;
  const int v = wr.table_values ? value_words : 0;
  if (v == 0) {
    if constexpr (FOLD) return (int)cudaErrorInvalidValue;
    else return walk<KW, 0, false>(table_keys, wr, keys, status, n, num_rows,
                                   window, seed, linear, max_probes,
                                   match_pass, stream);
  }
  if (v == 1) return walk<KW, 1, FOLD>(table_keys, wr, keys, status, n,
                                       num_rows, window, seed, linear,
                                       max_probes, match_pass, stream);
  // the inserts store one value plane
  if constexpr (!FOLD) return (int)cudaErrorInvalidValue;
  else return walk<KW, 2, true>(table_keys, wr, keys, status, n, num_rows,
                                window, seed, linear, max_probes, match_pass,
                                stream);
}

// The retrieve of n queries: at W >= 32 retrieve_walk_kernel,
// kRetrieveKeys queries a warp (COLLECT with the arenas); below,
// retrieve_kernel, 32 / W queries a warp.
template <int KW>
int retrieve(const void* table_keys, const void* keys, const void* active,
             void* counts, void* qarena, void* rank_arena, long long n,
             unsigned num_rows, int window, unsigned seed, int linear,
             long long max_probes, void* stream) {
  if (n <= 0) return 0;
  const Walk w = make_walk(num_rows, window, seed, linear, max_probes);
  const uint32_t* const tk = (const uint32_t*)table_keys;
  const uint32_t* const kk = (const uint32_t*)keys;
  const bool* const act = (const bool*)active;
  int* const cnt = (int*)counts;
  int* const qa = (int*)qarena;
  int* const ra = (int*)rank_arena;
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned blocks = walk_blocks(n, kRetrieveKeys);
  if (window >= 32 && qa)
    retrieve_walk_kernel<KW, kRetrieveKeys, true>
        <<<blocks, kThreads, 0, s>>>(tk, kk, act, cnt, qa, ra, n, w);
  else if (window >= 32)
    retrieve_walk_kernel<KW, kRetrieveKeys, false>
        <<<blocks, kThreads, 0, s>>>(tk, kk, act, cnt, qa, ra, n, w);
  else
    retrieve_kernel<KW><<<blocks_for(n, window), kThreads, 0, s>>>(
        tk, kk, act, cnt, qa, ra, n, w);
  return (int)cudaGetLastError();
}

// The stores of the insert: `values` into one plane (or none), no folds.
Writes plain_writes(void* table_values, const void* values) {
  return {table_values, 0, values, values, nullptr, nullptr, nullptr, 0};
}

// The append of n pairs (see the header): one group per G pairs.
template <int KW>
int append(void* table_keys, void* table_values, const void* keys,
           const void* values, void* status, long long n, unsigned num_rows,
           int window, unsigned seed, int linear, long long max_probes,
           void* stream) {
  if (n <= 0) return 0;
  if (!table_values) return (int)cudaErrorInvalidValue;
  const int g = window < 32 ? window : 32;
  append_kernel<KW><<<blocks_for((n + g - 1) / g, window), kThreads, 0,
                      (cudaStream_t)stream>>>(
      (uint32_t*)table_keys, (uint32_t*)table_values, (const uint32_t*)keys,
      (const uint32_t*)values, (int*)status, n,
      make_walk(num_rows, window, seed, linear, max_probes));
  return (int)cudaGetLastError();
}

}  // namespace

// Every entry point launches on `stream`, allocates nothing, does not
// synchronise, and returns cudaGetLastError() of its launches (0 =
// success).  `table_keys` is the (KW, p, W) key planes, `keys` the (n, KW)
// key batch; the other planes are (p, W) and the other batches (n,).
// `table_values` of the insert and the lookup may be null (a hash set: no
// value plane; then `values` is null too).
extern "C" int cops_insert(void* table_keys, void* table_values,
                           const void* keys, const void* values, void* status,
                           long long n, unsigned num_rows, int window,
                           unsigned seed, int linear, long long max_probes,
                           void* stream) {
  return launch<1, false>(table_keys, plain_writes(table_values, values), 1,
                          keys, status, n, num_rows, window, seed, linear,
                          max_probes, -1, stream);
}

// The two passes of the header; `match_pass` = 0 skips pass 1 (an empty
// store holds no key).
extern "C" int cops_insert64(void* table_keys, void* table_values,
                             const void* keys, const void* values,
                             void* status, long long n, unsigned num_rows,
                             int window, unsigned seed, int linear,
                             long long max_probes, int match_pass,
                             void* stream) {
  return launch<2, false>(table_keys, plain_writes(table_values, values), 1,
                          keys, status, n, num_rows, window, seed, linear,
                          max_probes, match_pass, stream);
}

// The read-modify-write of a batch (see the header): `keys` the n DISTINCT
// representatives with their (n, value_words) `operand` and `claimv`
// (init) words; `table_values` is `value_words` (1 or 2) (p, W) planes;
// `ops` holds the fold of value plane p in bits 4p .. 4p + 3 (0 add, 1
// min, 2 max, 3 saturating add, all u32).  The batch's (n_rest,)
// `rest_rep` (the representative of each other live row, -1 for none) and
// (n_rest, value_words) `rest_operand` are combined into `acc`, (n,
// value_words) words that the caller filled with each op's identity (0;
// 0xFFFFFFFF for min), which the walk then folds in; with n_rest = 0 these
// three may be null.
extern "C" int cops_update(void* table_keys, void* table_values,
                           const void* keys, const void* operand,
                           const void* claimv, void* status,
                           const void* rest_rep, const void* rest_operand,
                           void* acc, long long n, unsigned num_rows,
                           int window, unsigned seed, int linear,
                           long long max_probes, int value_words, int ops,
                           long long n_rest, void* stream) {
  return launch<1, true>(
      table_keys,
      {table_values, ops, operand, claimv, rest_rep, rest_operand, acc,
       n_rest},
      value_words, keys, status, n, num_rows, window, seed, linear,
      max_probes, -1, stream);
}

// cops_update for two-plane keys: the same combine, then the two passes of
// cops_insert64.
extern "C" int cops_update64(void* table_keys, void* table_values,
                             const void* keys, const void* operand,
                             const void* claimv, void* status,
                             const void* rest_rep, const void* rest_operand,
                             void* acc, long long n, unsigned num_rows,
                             int window, unsigned seed, int linear,
                             long long max_probes, int value_words, int ops,
                             long long n_rest, int match_pass, void* stream) {
  return launch<2, true>(
      table_keys,
      {table_values, ops, operand, claimv, rest_rep, rest_operand, acc,
       n_rest},
      value_words, keys, status, n, num_rows, window, seed, linear,
      max_probes, match_pass, stream);
}

// The most representatives whose combine runs in shared memory (R).
extern "C" int cops_update_shared_groups() { return kSharedGroups; }

// The chains a warp of the bucket walk (K).
extern "C" int cops_bucket_keys() { return kBucketKeys; }

// `slots` (int64) and `plen` (int32: each key's probe length, the windows
// its walk examined) may be null.
extern "C" int cops_lookup(const void* table_keys, const void* table_values,
                           const void* keys, void* values, void* found,
                           void* slots, void* plen, long long n,
                           unsigned num_rows, int window, unsigned seed,
                           int linear, long long max_probes, void* stream) {
  return lookup<1>(table_keys, table_values, keys, values, found, slots,
                   plen, n, num_rows, window, seed, linear, max_probes,
                   stream);
}

extern "C" int cops_lookup64(const void* table_keys, const void* table_values,
                             const void* keys, void* values, void* found,
                             void* slots, void* plen, long long n,
                             unsigned num_rows, int window, unsigned seed,
                             int linear, long long max_probes, void* stream) {
  return lookup<2>(table_keys, table_values, keys, values, found, slots,
                   plen, n, num_rows, window, seed, linear, max_probes,
                   stream);
}

extern "C" int cops_append(void* table_keys, void* table_values,
                           const void* keys, const void* values, void* status,
                           long long n, unsigned num_rows, int window,
                           unsigned seed, int linear, long long max_probes,
                           void* stream) {
  return append<1>(table_keys, table_values, keys, values, status, n,
                   num_rows, window, seed, linear, max_probes, stream);
}

extern "C" int cops_append64(void* table_keys, void* table_values,
                             const void* keys, const void* values,
                             void* status, long long n, unsigned num_rows,
                             int window, unsigned seed, int linear,
                             long long max_probes, void* stream) {
  return append<2>(table_keys, table_values, keys, values, status, n,
                   num_rows, window, seed, linear, max_probes, stream);
}

// `qarena` / `rank_arena` are both null (counts only) or both (p * W,)
// planes that the caller filled with n and 0.
extern "C" int cops_retrieve(const void* table_keys, const void* keys,
                             const void* active, void* counts, void* qarena,
                             void* rank_arena, long long n, unsigned num_rows,
                             int window, unsigned seed, int linear,
                             long long max_probes, void* stream) {
  return retrieve<1>(table_keys, keys, active, counts, qarena, rank_arena, n,
                     num_rows, window, seed, linear, max_probes, stream);
}

extern "C" int cops_retrieve64(const void* table_keys, const void* keys,
                               const void* active, void* counts,
                               void* qarena, void* rank_arena, long long n,
                               unsigned num_rows, int window, unsigned seed,
                               int linear, long long max_probes,
                               void* stream) {
  return retrieve<2>(table_keys, keys, active, counts, qarena, rank_arena, n,
                     num_rows, window, seed, linear, max_probes, stream);
}

// The bucket list's chain walk: `pool` (P,) u32; `ptr`, `cnt`, `bidx`,
// `active` (n,) the pre-probed handles; `sizes`, `cum` the growth schedule
// (cum[j] = values held in buckets 0 .. j-1); `qarena` / `rank_arena` (P,)
// planes that the caller filled with n and 0.
extern "C" int cops_bucket_walk(const void* pool, const void* ptr,
                                const void* cnt, const void* bidx,
                                const void* active, const void* sizes,
                                const void* cum, void* qarena,
                                void* rank_arena, long long n, void* stream) {
  if (n <= 0) return 0;
  bucket_walk_kernel<kBucketKeys>
      <<<walk_blocks(n, kBucketKeys), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)pool, (const uint32_t*)ptr, (const int*)cnt,
      (const int*)bidx, (const bool*)active, (const int*)sizes,
      (const int*)cum, (int*)qarena, (int*)rank_arena, n);
  return (int)cudaGetLastError();
}
