"""The contracts that hold the concurrent insert kernels to the plain engine.

``cops_insert`` and ``cops_append`` claim slots with atomicCAS, so where
two elements race for a window their slot placement may differ from the
sequential order that ``insert_plain`` / ``append_plain`` (and the JAX
reference) replay.  They are held to four parts instead of bit-exact
planes (ROADMAP.md).

The single-value insert (``check_insert``):

1. the same live key -> value map;
2. the same per-element statuses whenever no element reports FULL;
3. every live key at or before the first EMPTY window of its walk —
   checked as: a plain lookup of every live key finds it at its own slot
   (a lookup stops at the first EMPTY window, and would also find an
   earlier second copy first);
4. retrieve parity on the store it built (the caller compares the lookup
   kernel with ``lookup_plain`` there).

The multi-value append (``check_append``):

1. the same multiset of live (key, value) pairs;
2. the same statuses when no element is FULL; otherwise every element the
   kernel reports FULL finds no EMPTY / TOMBSTONE lane in any window of
   its walk within the budget, in the store the kernel built;
3. every live pair at or before the first EMPTY window of its key's walk
   — checked as: the plain counting walk on the kernel-built store counts
   every live pair of each key;
4. the plain collecting walk gives, per key, the same multiset of values
   on the kernel-built store as on the plain-built one (the caller holds
   the ``cops_retrieve`` kernel bit-exact to ``retrieve_walk_plain``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import probing
from repro_torch.core.common import (
    DEFAULT_SEED,
    EMPTY_WORD,
    STATUS_FULL,
    STATUS_INSERTED,
    TOMBSTONE_WORD,
    as_u32,
    as_word,
)
from repro_torch.kernels.cops import ops

LOAD = 0.8      # the multi-value case's target load: Fig. 7's wc-oa


def live_map(table_keys, table_values):
    """(keys, values, slots) of the live slots, sorted by key (int64 u32)."""
    flat_k = table_keys.reshape(-1)
    slots = torch.nonzero((flat_k != EMPTY_WORD)
                          & (flat_k != TOMBSTONE_WORD)).squeeze(1)
    keys = as_u32(flat_k[slots])
    order = torch.argsort(keys)
    return (keys[order], as_u32(table_values.reshape(-1)[slots][order]),
            slots[order])


def check_insert(kernel_planes, plain_planes, kernel_status, plain_status, *,
                 seed, scheme, max_probes) -> dict[str, bool]:
    """Parts 1-3 for one batch; ``*_planes`` are (keys, values) pairs of
    (p, W) int32 tensors after the batch.  Returns ``{part: holds}``."""
    kk, kv, kslots = live_map(*kernel_planes)
    pk, pv, _ = live_map(*plain_planes)
    same_map = bool(kk.shape == pk.shape and torch.equal(kk, pk)
                    and torch.equal(kv, pv))
    full = bool((kernel_status == STATUS_FULL).any()
                or (plain_status == STATUS_FULL).any())
    same_status = full or bool(torch.equal(kernel_status, plain_status))
    _, found, slot = ops.lookup_plain(*kernel_planes, as_word(kk), seed=seed,
                                      scheme=scheme, max_probes=max_probes,
                                      slots=True)
    frontier = bool(found.all() and torch.equal(slot, kslots))
    return {"same_map": same_map, "same_status": same_status,
            "before_first_empty": frontier}


def live_pairs(table_keys, table_values):
    """Every live slot's (key, value) as one int64 ``key << 32 | value``,
    sorted: the store's pair multiset."""
    flat_k = table_keys.reshape(-1)
    live = (flat_k != EMPTY_WORD) & (flat_k != TOMBSTONE_WORD)
    pairs = ((as_u32(flat_k[live]) << 32)
             | as_u32(table_values.reshape(-1)[live]))
    return torch.sort(pairs).values


def walk_has_free(table_keys, keys, *, seed, scheme, max_probes):
    """Per key: does a window of its walk within the budget hold an EMPTY
    or TOMBSTONE lane?"""
    num_rows = table_keys.shape[0]
    free_row = ((table_keys == EMPTY_WORD)
                | (table_keys == TOMBSTONE_WORD)).any(dim=1)
    words = as_u32(keys)
    row = probing.initial_row(words, num_rows, seed)
    step = probing.row_step(scheme, words, num_rows, seed)
    found = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    for attempt in range(max_probes):
        found |= free_row[row]
        row = probing.advance_row(row, step, num_rows)
        if attempt % 64 == 63 and bool(found.all()):
            break
    return found


def _walk_pairs(planes, keys, kw):
    """(counts, sorted key << 32 | value of every slot the plain collecting
    walk of the distinct ``keys`` stamps)."""
    every = torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
    counts, qa, _ = ops.retrieve_walk_plain(planes[0], keys, every,
                                            collect=True, **kw)
    slots = torch.nonzero(qa < keys.shape[0]).squeeze(1)
    pairs = ((as_u32(keys[qa[slots].long()]) << 32)
             | as_u32(planes[1].reshape(-1)[slots]))
    return counts, torch.sort(pairs).values


def check_append(kernel_planes, plain_planes, keys, kernel_status,
                 plain_status, *, seed, scheme, max_probes) -> dict[str, bool]:
    """Parts 1-4 for one appended batch ``keys``; ``*_planes`` are (keys,
    values) pairs of (p, W) int32 tensors after it.  ``{part: holds}``."""
    kw = dict(seed=seed, scheme=scheme, max_probes=max_probes)
    kpairs = live_pairs(*kernel_planes)
    same_pairs = torch.equal(kpairs, live_pairs(*plain_planes))
    full = kernel_status == STATUS_FULL
    if bool(full.any() or (plain_status == STATUS_FULL).any()):
        same_status = not bool(walk_has_free(kernel_planes[0], keys[full],
                                             **kw).any())
    else:
        same_status = torch.equal(kernel_status, plain_status)
    distinct, mult = torch.unique_consecutive(kpairs >> 32,
                                              return_counts=True)
    distinct = as_word(distinct)
    kcounts, kwalk = _walk_pairs(kernel_planes, distinct, kw)
    _, pwalk = _walk_pairs(plain_planes, distinct, kw)
    return {"same_pairs": bool(same_pairs), "same_status": bool(same_status),
            "before_first_empty": torch.equal(kcounts.long(), mult),
            "same_retrieve": torch.equal(kwalk, pwalk)}


def check_walk(table_keys, keys, active, *, seed, scheme, max_probes,
               ) -> dict[str, bool]:
    """``retrieve_walk`` bit-exact against ``retrieve_walk_plain`` on the
    same store: counts only, and counts + both arenas."""
    out = {}
    for collect in (False, True):
        got = ops.retrieve_walk(table_keys, keys, active, seed=seed,
                                scheme=scheme, max_probes=max_probes,
                                collect=collect)
        want = ops.retrieve_walk_plain(table_keys, keys, active, seed=seed,
                                       scheme=scheme, max_probes=max_probes,
                                       collect=collect)
        out["collect" if collect else "counts"] = all(
            (a is None and b is None) or (a is not None and b is not None
                                          and torch.equal(a, b))
            for a, b in zip(got, want))
    return out


# ---------------------------------------------------------------------------
# one kernel-vs-plain case, on any device
# ---------------------------------------------------------------------------

def distinct_keys(start: int, count: int, device) -> torch.Tensor:
    """``count`` distinct u32 keys (int32 words), none a sentinel: murmur3
    (a bijection on u32) over ``start, start + 1, ...``."""
    from repro_torch.core import hashing
    i = torch.arange(start, start + count + 2, dtype=torch.int64,
                     device=device)
    k = hashing.mix_murmur3(i)
    k = k[k < TOMBSTONE_WORD + 2 ** 32][:count]     # drop EMPTY / TOMBSTONE
    return as_word(k)


def values_for(keys: torch.Tensor, salt: int) -> torch.Tensor:
    from repro_torch.core import hashing
    return as_word(hashing.mix_xxhash(as_u32(keys) ^ salt))


def run_case(n: int, *, window: int, scheme: str, device, rho: float = 0.9,
             seed: int = 0x9E3779B9) -> dict[str, bool]:
    """Hold ``cops_insert`` / ``cops_lookup`` (or, on the CPU, whatever
    ``ops.insert`` / ``ops.lookup`` run) against the plain versions.

    Batch 1 inserts ``n`` distinct keys at load ``rho``; then 1/8 of them
    are erased (tombstones), and batch 2 — n/4 elements, half present keys
    with new values, half new keys, 1/8 in-batch duplicates — is deduped
    and upserted onto that store.  After each batch: contract parts 1-3,
    and the lookup on the kernel-built store, bit-exact against
    ``lookup_plain`` for present and absent keys.
    """
    from repro_torch.core import bulk, single_value
    table = single_value.create(int(n / rho), window=window, scheme=scheme,
                                seed=seed, device=device)
    budget = bulk._tstatic(table)[3]
    kw = dict(seed=seed, scheme=scheme, max_probes=budget)
    kernel = (table.store["keys"][0], table.store["values"][0])
    plain = tuple(t.clone() for t in kernel)
    keys = distinct_keys(0, n + n // 8, device)
    keys, absent = keys[:n], keys[n:]
    checks = {}

    def upsert(rkeys, rvals, count, tag):
        ks = ops.insert(*kernel, rkeys, rvals, count=count, **kw)
        ps = ops.insert_plain(*plain, rkeys, rvals, count=count, **kw)
        for part, ok in check_insert(kernel, plain, ks, ps, **kw).items():
            checks[f"{tag}_{part}"] = ok
        queries = torch.cat([rkeys, absent])
        got = ops.lookup(*kernel, queries, slots=True, **kw)
        want = ops.lookup_plain(*kernel, queries, slots=True, **kw)
        checks[f"{tag}_lookup_exact"] = all(torch.equal(a, b)
                                            for a, b in zip(got, want))
        return int((ks == 0).sum())

    count = upsert(keys, values_for(keys, 1), 0, "batch1")
    gone = keys[: n // 8]
    for planes in (kernel, plain):
        _, found, slot = ops.lookup_plain(*planes, gone, slots=True, **kw)
        planes[0].view(-1)[slot[found]] = TOMBSTONE_WORD
    count -= gone.shape[0]
    m = n // 8
    batch = torch.cat([keys[n // 8: n // 8 + m], distinct_keys(n + n // 8 + 2,
                                                               m, device)])
    dups = batch.shape[0] // 8
    batch[-dups:] = batch[:dups]                     # in-batch duplicates
    rkeys, rvals, _ = bulk.dedup(batch, values_for(batch, 2))
    upsert(rkeys, rvals, count, "batch2")
    return checks


def run_multi_case(n: int, *, window: int, scheme: str, device, r: int = 8,
                   max_probes: int | None = None) -> dict[str, bool]:
    """Hold ``cops_append`` / ``cops_retrieve`` (or, on the CPU, whatever
    ``ops.append`` / ``ops.retrieve_walk`` run) against the plain versions.

    Batch 1 appends ``n`` pairs at load ``LOAD``: ``n / r`` distinct keys,
    each repeated ``r`` times in a row (Fig. 7's layout), values
    ``0 .. n-1``.  Then 1/8 of the keys are erased through
    ``multi_value.erase`` (tombstones), and batch 2 — n/8 pairs, half new
    pairs of present keys, half new keys — is appended onto that store.
    After each batch: contract parts 1-4, the live count, and the walk on
    the kernel-built store, bit-exact against ``retrieve_walk_plain``
    (counts only and collecting) for present and absent keys, a batch
    holding duplicates and a masked batch.
    """
    from repro_torch.core import bulk, bulk_retrieve, multi_value
    ktab = multi_value.create(int(n / LOAD), window=window, scheme=scheme,
                              max_probes=max_probes, device=device)
    ptab = dataclasses.replace(
        ktab, store={k: v.clone() for k, v in ktab.store.items()})
    kw = dict(seed=DEFAULT_SEED, scheme=scheme,
              max_probes=bulk._tstatic(ktab)[3])
    nk = max(16, n // r)
    pool = distinct_keys(0, nk + nk // 8 + nk // 16, device)
    base, absent, new = pool[:nk], pool[nk:nk + nk // 8], pool[nk + nk // 8:]
    checks = {}

    def planes(t):
        return t.store["keys"][0], t.store["values"][0]

    def walks(tag, queries):
        dup = torch.cat([queries[: nk // 4], queries[: nk // 4]])
        masked = torch.arange(queries.shape[0], device=device) % 3 != 0
        for name, q, live in (("present_absent", torch.cat([queries, absent]),
                               None),
                              ("duplicates", dup, None),
                              ("masked", queries, masked)):
            live = (torch.ones(q.shape, dtype=torch.bool, device=device)
                    if live is None else live)
            reps, _ = bulk_retrieve.group_queries(q, live)
            for mode, ok in check_walk(planes(ktab)[0], q, reps,
                                       **kw).items():
                checks[f"{tag}_walk_{name}_{mode}"] = ok

    def append(tag, keys, start):
        nonlocal ktab, ptab
        vals = torch.arange(start, start + keys.shape[0], dtype=torch.int32,
                            device=device)
        ks = ops.append(*planes(ktab), keys, vals, **kw)
        ps = ops.append_plain(*planes(ptab), keys, vals, **kw)
        for part, ok in check_append(planes(ktab), planes(ptab), keys, ks, ps,
                                     **kw).items():
            checks[f"{tag}_{part}"] = ok
        ktab = dataclasses.replace(
            ktab, count=ktab.count + int((ks == STATUS_INSERTED).sum()))
        checks[f"{tag}_count"] = (
            ktab.count == live_pairs(*planes(ktab)).shape[0])

    append("batch1", base.repeat_interleave(r), 0)
    walks("batch1", base)
    gone = base[: nk // 8]
    ktab, erased = multi_value.erase(ktab, gone)
    every = torch.ones(gone.shape, dtype=torch.bool, device=device)
    pcnt, pqa, _ = ops.retrieve_walk_plain(planes(ptab)[0], gone, every,
                                           collect=True, **kw)
    ptab.ops.tombstone_slots(ptab.store,
                             torch.nonzero(pqa < gone.shape[0]).squeeze(1))
    checks["erase_counts"] = torch.equal(erased, pcnt)
    checks["erase_same_pairs"] = torch.equal(live_pairs(*planes(ktab)),
                                             live_pairs(*planes(ptab)))
    half = nk // 16
    batch2 = torch.cat([base[nk // 8: nk // 8 + half], new[:half]])
    append("batch2", batch2.repeat_interleave(r), n)
    walks("batch2", torch.cat([base, new[:half]]))
    return checks
