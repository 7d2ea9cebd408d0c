"""The contract that holds a concurrent insert kernel to the plain engine.

``cops_insert`` claims slots with atomicCAS, so where two keys race for a
window its slot placement may differ from the sequential order that
``insert_plain`` (and the JAX reference) replays.  It is held to four
parts instead of bit-exact planes (ROADMAP.md):

1. the same live key -> value map;
2. the same per-element statuses whenever no element reports FULL;
3. every live key at or before the first EMPTY window of its walk —
   checked as: a plain lookup of every live key finds it at its own slot
   (a lookup stops at the first EMPTY window, and would also find an
   earlier second copy first);
4. retrieve parity on the store it built (the caller compares the lookup
   kernel with ``lookup_plain`` there).
"""

from __future__ import annotations

import torch

from repro_torch.core.common import (
    EMPTY_WORD,
    STATUS_FULL,
    TOMBSTONE_WORD,
    as_u32,
    as_word,
)
from repro_torch.kernels.cops import ops


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
