"""BucketListHashTable — the memory-compact multi-value table (paper §IV-C, Fig. 3).

The port of ``repro.core.bucket_list`` for 1-word u32 keys and values,
on the SOA key store with the cops and linear schemes.  Each key lives
once in a single-value key store whose value is a packed two-word *list
handle*:

  word 0: pool address of the tail bucket
  word 1: [ count : 22 | bucket_idx : 8 | state : 2 ]

The values live in linked lists of contiguous *buckets* bump-allocated
from one pre-allocated value pool.  Bucket sizes follow the paper's growth
schedule s_i = ceil(growth * s_{i-1}) (``growth_schedule``); every bucket
but the first starts with a link slot holding the previous bucket's
address, so a list is walked tail -> head (Fig. 4).  Because the handle
carries the count, ``count_values`` is one key-store lookup per query, no
chain walk.

- ``insert`` is the JAX package's batched build (``_insert_bulk``),
  bit-exact against it: a stable sort groups the batch per key in batch
  order (``bulk._sort_batch`` / ``_group_structure``), one lookup per
  distinct key reads the handles of the keys already present, the value
  that opens a bucket draws its base address from a prefix sum of the
  batch's allocation sizes in batch order, and new keys claim their
  key-store slot through ``bulk.place_claims`` with each key's batch
  position as its priority.  Pool exhaustion and a full key store are the
  JAX engine's two fixpoints, run here as host loops that make one pass
  each when nothing overflows.
- ``retrieve_all`` dedups the queries, reads each distinct key's handle,
  walks its chain with ``kernels.cops.ops.bucket_walk`` (the
  ``cops_bucket_walk`` kernel on a CUDA table, its plain version on a CPU
  table), which stamps (query, head-first rank) into two pool-sized
  arenas, and compacts them with ``bulk_retrieve._emit`` into the paper's
  (values, offsets, counts) layout, values in insertion order.

Every key-store walk (the build's probe of existing keys, the handle
probe, ``count_values``) goes through ``kernels.cops.ops.lookup(...,
slots=True)``, the ``cops_lookup`` kernel on a CUDA table; both handle
words are then gathered by slot.  A table lives on one device, chosen at
``create`` as in ``single_value`` (``device=None`` means the CUDA card).
``insert`` updates the key store and the pool in place and returns a table
that shares them, carrying the new ``alloc_top`` and key count.

Not ported: ``insert_or_grow``, ``for_each``, the ``backend="scan"``
references, the dense mode of ``chain_arena`` and two-word keys (ROADMAP.md
queue 1 item 5b); ``stats=True`` is refused naming the same item (the
open-addressing tables carry it, ``obs.metrics``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import bulk, bulk_retrieve
from repro_torch.core import single_value as sv
from repro_torch.core.common import (
    DEFAULT_SEED,
    DEFAULT_WINDOW,
    EMPTY_WORD,
    STATUS_FULL,
    STATUS_INSERTED,
    STATUS_MASKED,
    STATUS_POOL_FULL,
    TOMBSTONE_WORD,
    as_u32,
    as_word,
)

# handle word 1 bit layout
_COUNT_SHIFT = 10
_BUCKET_SHIFT = 2
_BUCKET_MASK = 0xFF
_STATE_MASK = 0x3
STATE_UNINIT, STATE_BLOCKED, STATE_READY, STATE_FULL = 0, 1, 2, 3
MAX_COUNT = (1 << 22) - 1


def pack_handle(ptr, count, bucket_idx, state) -> torch.Tensor:
    """(..., 2) int32 handle words from integer tensors (or ints)."""
    w1 = ((torch.as_tensor(count).to(torch.int64) << _COUNT_SHIFT)
          | (torch.as_tensor(bucket_idx).to(torch.int64) << _BUCKET_SHIFT)
          | torch.as_tensor(state).to(torch.int64))
    ptr = torch.as_tensor(ptr).to(torch.int64).expand_as(w1)
    return torch.stack([as_word(ptr), as_word(w1)], dim=-1)


def unpack_handle(handle: torch.Tensor):
    """``(ptr, count, bucket_idx, state)`` of (..., 2) handle words, each
    int64.  Word 1 is read as u32 (a count of 2^21 or more sets its top
    bit)."""
    w1 = as_u32(handle[..., 1])
    return (as_u32(handle[..., 0]), w1 >> _COUNT_SHIFT,
            (w1 >> _BUCKET_SHIFT) & _BUCKET_MASK, w1 & _STATE_MASK)


def growth_schedule(s0: int, growth: float, pool_capacity: int,
                    max_buckets: int = 64) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Bucket sizes s_i = ceil(growth * s_{i-1}) and exclusive cumulative value
    capacity C_i (values held in buckets 0..i-1).  Truncated once C covers the
    pool (no key can ever need more buckets)."""
    sizes, cum = [], [0]
    s = int(s0)
    while len(sizes) < max_buckets and cum[-1] < pool_capacity:
        sizes.append(s)
        cum.append(cum[-1] + s)
        s = int(math.ceil(growth * s))
    return tuple(sizes), tuple(cum)


@dataclasses.dataclass
class BucketListHashTable:
    key_store: sv.SingleValueHashTable   # value_words=2: the list handles
    pool: torch.Tensor                   # (pool_capacity,) int32 value + link slots
    alloc_top: int                       # the bump allocator
    pool_capacity: int
    sizes: tuple                         # bucket value capacities per index
    cum: tuple                           # exclusive cumulative value capacity
    s0: int
    growth: float

    @property
    def key_capacity(self) -> int:
        return self.key_store.capacity

    @property
    def device(self) -> torch.device:
        return self.pool.device

    def num_keys(self) -> int:
        return self.key_store.count

    def storage_density(self) -> float:
        """Stored information bits / allocated bits (the paper's rho,
        §IV-C), in float32 as the JAX package computes it."""
        stored = self.key_store.count * 2 + int(self._counts_all().sum())
        allocated = self.key_store.capacity * 3 + self.pool_capacity
        return float(np.float32(stored) / np.float32(allocated))

    def _counts_all(self) -> torch.Tensor:
        kp = self.key_store.store["keys"][0].reshape(-1)
        live = (kp != EMPTY_WORD) & (kp != TOMBSTONE_WORD)
        w1 = as_u32(self.key_store.store["values"][1].reshape(-1))
        return torch.where(live, w1 >> _COUNT_SHIFT, 0)


def create(key_capacity: int, pool_capacity: int, *, s0: int = 1,
           growth: float = 1.1, window: int = DEFAULT_WINDOW,
           scheme: str = "cops", seed: int = DEFAULT_SEED,
           key_words: int = 1, device=None) -> BucketListHashTable:
    """An empty bucket list: a key store of capacity >= ``key_capacity``
    and a value pool of ``pool_capacity`` slots."""
    if key_words == 2:
        raise NotImplementedError(
            "two-word keys on the bucket list are not ported to repro_torch "
            "yet: see ROADMAP.md queue 1 item 5b (the rest of the bucket "
            "list)")
    sv.check_ported(key_words, 1, scheme, "soa")
    if not 0 < pool_capacity < 2 ** 31:
        raise ValueError(f"pool_capacity={pool_capacity} must be in [1, 2^31)")
    key_store = sv.empty_table(key_capacity, window=window, scheme=scheme,
                               seed=seed, max_probes=None, device=device,
                               key_words=key_words, value_words=2)
    sizes, cum = growth_schedule(s0, growth, pool_capacity)
    return BucketListHashTable(
        key_store=key_store,
        pool=torch.zeros((pool_capacity,), dtype=torch.int32,
                         device=key_store.device),
        alloc_top=0, pool_capacity=pool_capacity, sizes=sizes, cum=cum,
        s0=s0, growth=growth)


def _schedule(table: BucketListHashTable):
    """The growth schedule as int32 (sizes, cum) tensors on the device."""
    return (torch.tensor(table.sizes, dtype=torch.int32, device=table.device),
            torch.tensor(table.cum, dtype=torch.int32, device=table.device))


def _check_stats(stats: bool) -> None:
    """Take the reference's ``stats`` keyword: ``False`` is the only value
    the bucket list carries."""
    if stats:
        raise NotImplementedError(
            "stats=True on a bucket list is not ported to repro_torch yet: "
            "see ROADMAP.md queue 1 item 5b (the rest of the bucket list)")


def _lookup(ks: sv.SingleValueHashTable, keys: torch.Tensor):
    """``(found, slot, handles)`` of (m,) keys: one ``cops_lookup`` walk
    each, its flat slot (-1 where absent), then both handle words gathered
    by slot ((m, 2) int32; zero where absent)."""
    from repro_torch.kernels.cops import ops as cops_ops
    _, scheme, seed, max_probes = bulk._tstatic(ks)
    _, found, slot = cops_ops.lookup(
        ks.store["keys"][0], ks.store["values"][0], keys, seed=seed,
        scheme=scheme, max_probes=max_probes, slots=True)
    handles = ks.ops.arena_values(ks.store, slot.clamp(min=0))
    return found, slot, torch.where(found[:, None], handles, 0)


# ---------------------------------------------------------------------------
# insertion — the batched build
# ---------------------------------------------------------------------------

def insert(table: BucketListHashTable, keys, values, mask=None,
           stats: bool = False):
    """Insert (key, value) pairs: a new key allocates its first bucket, a
    present key appends to its tail bucket and grows its list when the
    tail is full.  Returns (table, status (n,) int32: INSERTED / FULL /
    POOL_FULL / MASKED)."""
    _check_stats(stats)
    keys = sv.normalize_key_batch(keys, 1, table.device)
    values = sv.normalize_words(values, 1, "values", table.device)
    if values.shape[0] != keys.shape[0]:
        raise ValueError(f"{values.shape[0]} values for {keys.shape[0]} keys")
    mask = sv.normalize_mask(mask, keys.shape[0], table.device)
    return _insert_bulk(table, keys, values, mask)


def _insert_bulk(table: BucketListHashTable, keys, values, mask):
    """The batched build, bit-exact against the JAX package's
    ``_insert_bulk`` and its sequential reference (see there):

    1. **Group**: sort the batch by (masked, key, batch index); element
       ``t`` of a key's run carries the running count ``c = count0 + t``
       (``count0`` off the pre-batch handle, 0 for a new key) and opens
       bucket ``j`` exactly when ``c == cum[j]``.
    2. **Allocate**: bucket-opening elements take their bucket's address
       from a prefix sum of allocation sizes in batch order.  A key is
       frozen from its first failing allocation on (the earliest failure
       in batch order is exact), and the sweep repeats.
    3. **Claim**: new keys whose first allocation succeeded claim a
       key-store slot (``bulk.place_claims``, priority = batch position);
       keys found FULL demand no pool, so 2 and 3 alternate until FULL is
       stable.
    4. **Apply**: one pool write of the values, one of the links, one
       key-store write of the claimed keys and final handles.

    Per-element arrays are int32 where the values fit; per-key arrays are
    indexed by the group's representative (``rep``), with one sentinel
    entry more for masked elements.
    """
    ks = table.key_store
    n, dev = keys.shape[0], keys.device
    if n == 0:
        return table, torch.zeros((0,), dtype=torch.int32, device=dev)
    i32 = torch.int32
    sizes, cum = _schedule(table)
    n_sizes = len(table.sizes)
    pool_cap = table.pool_capacity
    top0 = table.alloc_top

    # ---- 1. group structure in the sorted domain ---------------------------
    flag, skeys, sidx, (svals,) = bulk._sort_batch(keys, mask, [values])
    live, is_rep, first_pos, last_pos = bulk._group_structure(flag, skeys)
    del flag
    reps = torch.nonzero(is_rep).squeeze(1)               # sorted positions
    m = reps.shape[0]
    # each element's group: its representative's index in `reps` (m for a
    # masked element, the sentinel entry of every per-key array)
    rep_ix = torch.cumsum(is_rep, 0, dtype=i32) - 1
    g = torch.where(live, rep_ix[first_pos], m)
    del rep_ix, is_rep
    t = torch.arange(n, dtype=i32, device=dev) - first_pos  # rank in group
    lsize = (last_pos - first_pos + 1)[reps]                 # per key
    del last_pos

    # the handles of the keys already present
    def per_key(x, sentinel):
        return torch.cat([x, torch.full((1,), sentinel, dtype=x.dtype,
                                        device=dev)])

    matched = torch.zeros((m,), dtype=torch.bool, device=dev)
    mslot = torch.zeros((m,), dtype=torch.int64, device=dev)
    handles = torch.zeros((m, 2), dtype=i32, device=dev)
    if ks.count > 0 and m > 0:          # an empty store holds no key
        matched, mslot, handles = _lookup(ks, skeys[reps])
    ptr0_k, count0_k, bidx0_k, _ = unpack_handle(handles)
    count0_k = torch.where(matched, count0_k, 0).to(i32)
    exists = per_key(matched, False)[g]
    ptr0 = per_key(ptr0_k, 0)[g]
    count0 = per_key(count0_k, 0)[g]
    bidx0 = per_key(torch.where(matched, bidx0_k, -1).to(i32), -1)[g]
    del ptr0_k, bidx0_k, handles

    # ---- static bucket arithmetic per element ------------------------------
    c = count0 + t                                      # running count pre-write
    jr = torch.searchsorted(cum, c, out_int32=True)     # first j: cum[j] >= c
    boundary = cum[jr.clamp(max=n_sizes)] == c          # opens bucket jr
    sched_ok = jr < n_sizes
    jv = jr.clamp(0, n_sizes - 1)
    alloc_sz = sizes[jv] + (jv > 0).to(i32)             # data + prev-link slot
    del jr, jv
    jbkt = (torch.searchsorted(cum, c, right=True, out_int32=True) - 1
            ).clamp(0, n_sizes - 1)                     # bucket holding value c

    def alloc_prefix(gdead, full):
        """Admitted elements, bucket openers and their bump addresses
        (int64) for the current freeze / FULL assumption."""
        admit = live & ~full[g] & (t < gdead[g])
        trig = admit & boundary
        size_b = torch.zeros((n,), dtype=torch.int64, device=dev)
        size_b[sidx] = torch.where(trig & sched_ok, alloc_sz, 0).to(torch.int64)
        start_b = top0 + torch.cumsum(size_b, 0) - size_b
        return admit, trig, start_b[sidx]

    def alloc_fixpoint(full):
        """Freeze each key at its first failing allocation, one key per
        sweep, in batch order."""
        gdead = torch.full((m + 1,), n + 1, dtype=i32, device=dev)
        while True:
            _, trig, start = alloc_prefix(gdead, full)
            fail = trig & (~sched_ok | (start + alloc_sz > pool_cap))
            if not bool(fail.any()):
                return gdead
            k = torch.argmin(torch.where(fail, sidx, n))  # earliest in batch
            gdead[g[k]] = torch.minimum(gdead[g[k]], t[k])

    # ---- 2+3. the outer fixpoint: pool allocation <-> key-store claims -----
    tstat = bulk._tstatic(ks)
    full = torch.zeros((m + 1,), dtype=torch.bool, device=dev)
    while True:
        gdead = alloc_fixpoint(full)
        cl = torch.nonzero(~matched & (gdead[:m] > 0)).squeeze(1)
        placed_c, crow, clane, full_c = bulk.place_claims(
            tstat, ks.store, as_u32(skeys[reps[cl]]),
            torch.ones(cl.shape, dtype=torch.bool, device=dev),
            prio=sidx[reps[cl]])
        new_full = torch.zeros_like(full)
        new_full[cl] = full_c
        changed = bool((new_full != full).any())
        full = new_full
        if not changed:
            break

    # ---- 4. apply ----------------------------------------------------------
    admit, trig, start = alloc_prefix(gdead, full)
    new_top = top0 + int(torch.where(trig, alloc_sz, 0).sum())

    def bucket_start(j, at):
        """Base address (int64) of bucket ``j`` of the elements at sorted
        positions ``at``: a bucket opened in this batch reads the address
        of its opening element (sorted position first_pos + cum[j] -
        count0); the pre-batch tail keeps its handle's pointer."""
        jc = j.clamp(0, n_sizes - 1)
        tpos = (first_pos[at] + cum[jc] - count0[at]).clamp(0, n - 1)
        inbatch = ~exists[at] | (j != bidx0[at])
        return torch.where(inbatch, start[tpos], ptr0[at])

    pool = table.pool
    w = torch.nonzero(admit).squeeze(1)
    bstart = bucket_start(jbkt[w], w)
    jw = jbkt[w]
    pool[bstart + (jw > 0) + (c[w] - cum[jw])] = svals[w]
    # the link slot of every bucket j > 0 opened in this batch
    lk = trig[w] & (jw > 0)
    pool[bstart[lk]] = as_word(bucket_start(jw[lk] - 1, w[lk]))
    del w, bstart, jw, lk

    # final handle per key
    nwrit = torch.where(full[:m], 0, torch.minimum(gdead[:m], lsize))
    fcount = count0_k + nwrit
    fj = (torch.searchsorted(cum, (fcount - 1).clamp(min=0), right=True,
                             out_int32=True) - 1).clamp(0, n_sizes - 1)
    fhandle = pack_handle(bucket_start(fj, reps), fcount, fj, STATE_READY)
    placed = torch.zeros((m,), dtype=torch.bool, device=dev)
    placed[cl] = placed_c
    mslot[cl] = crow * ks.window + clane            # matched or claimed
    write = (matched & (nwrit > 0)) | placed
    ks.ops.scatter_batch(ks.store, mslot[write], skeys[reps][write][:, None],
                         fhandle[write], placed[write])

    status_s = torch.where(
        ~live, STATUS_MASKED,
        torch.where(admit, STATUS_INSERTED,
                    torch.where(full[g], STATUS_FULL, STATUS_POOL_FULL)))
    status = torch.empty((n,), dtype=i32, device=dev)
    status[sidx] = status_s.to(i32)
    new_ks = dataclasses.replace(ks, count=ks.count + int(placed.sum()))
    return dataclasses.replace(table, key_store=new_ks,
                               alloc_top=new_top), status


# ---------------------------------------------------------------------------
# retrieval — O(1) counts off the handles; the chain walk over the pool
# ---------------------------------------------------------------------------

def count_values(table: BucketListHashTable, keys,
                 stats: bool = False) -> torch.Tensor:
    """Per-key value count, int32, read off the handle (no chain walk)."""
    _check_stats(stats)
    keys = sv.normalize_key_batch(keys, 1, table.device)
    if keys.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.int32, device=table.device)
    found, _, handles = _lookup(table.key_store, keys)
    return torch.where(found, unpack_handle(handles)[1], 0).to(torch.int32)


def _handle_probe(table: BucketListHashTable, keys):
    """Dedup + one handle lookup per distinct query key: the retrieval's
    front end.  Returns ``(is_rep, rep_of, found, ptr, rcnt, bidx,
    counts)``, (n,) each: the handle fields (int32) are set where
    ``found`` (present representatives) and zero elsewhere; ``counts`` is
    already fanned out to every duplicate query."""
    n, dev = keys.shape[0], keys.device
    live = torch.ones((n,), dtype=torch.bool, device=dev)
    is_rep, rep_of = bulk_retrieve.group_queries(keys, live)
    reps = torch.nonzero(is_rep).squeeze(1)
    found_r, _, handles = _lookup(table.key_store, keys[reps])
    fields = [torch.zeros((n,), dtype=torch.int32, device=dev)
              for _ in range(3)]
    for field, value in zip(fields, unpack_handle(handles)):
        field[reps] = as_word(value)
    ptr, rcnt, bidx = fields
    found = torch.zeros((n,), dtype=torch.bool, device=dev)
    found[reps] = found_r
    counts = bulk_retrieve._fan_out(rcnt, rep_of, live, n)
    return is_rep, rep_of, found, ptr, rcnt, bidx, counts


def retrieve_all(table: BucketListHashTable, keys, out_capacity: int,
                 stats: bool = False):
    """Gather every value of each queried key, walking its bucket list.

    Returns ``(values (out_capacity,), offsets (n + 1,), counts (n,))``,
    int32: query i's values, in insertion order, are
    ``values[offsets[i]:offsets[i] + counts[i]]``.  Entries past the true
    total are zero, and values past ``out_capacity`` are dropped: size it
    with ``count_values``.  Duplicate queries walk once.
    """
    from repro_torch.kernels.cops import ops as cops_ops
    _check_stats(stats)
    keys = sv.normalize_key_batch(keys, 1, table.device)
    n, dev = keys.shape[0], table.device
    if n == 0:
        return (torch.zeros((int(out_capacity),), dtype=torch.int32,
                            device=dev),
                torch.zeros((1,), dtype=torch.int32, device=dev),
                torch.zeros((0,), dtype=torch.int32, device=dev))
    is_rep, rep_of, found, ptr, rcnt, bidx, counts = _handle_probe(table, keys)
    qa, ra = cops_ops.bucket_walk(table.pool, ptr, rcnt, bidx, found,
                                  *_schedule(table))
    out, offsets, counts = bulk_retrieve._emit(
        lambda s: table.pool[s][:, None], table.pool_capacity, out_capacity,
        counts, is_rep, rep_of, rcnt, qa, ra)
    return out[:, 0], offsets, counts
