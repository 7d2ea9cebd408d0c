"""The contracts that hold the concurrent insert kernels to the plain engine.

``cops_insert`` and ``cops_append``, and their two-plane twins
``cops_insert64`` and ``cops_append64``, claim slots with atomicCAS, so
where two elements race for a window their slot placement may differ from
the sequential order that ``insert_plain`` / ``append_plain`` (and the JAX
reference) replay.  They are held to four parts instead of bit-exact
planes (ROADMAP.md).  Every check takes the key planes as the wrappers
do: a (p, W) plane for 1-word keys, (2, p, W) planes for two-word keys,
whose key batches are (n, 2); keys are compared on every plane
(``bulk.pack_keys``).

The single-value insert (``check_insert``):

1. the same live key -> value map;
2. the same per-element statuses whenever no element reports FULL;
3. every live key at or before the first EMPTY window of its walk —
   checked as: a plain lookup of every live key finds it at its own slot
   (a lookup stops at the first EMPTY window, and would also find an
   earlier second copy first);
4. retrieve parity on the store it built (the caller compares the lookup
   kernel with ``lookup_plain`` there).

``run_case`` holds it at a table's scale, ``run_insert_race_case`` where
every key starts its walk on one row, so that the claims race.

The lookup writes nothing, so ``cops_lookup`` / ``cops_lookup64`` are held
bit-exact to ``lookup_plain`` (values, found and slots): after every batch
of the cases above, and in ``run_lookup_case`` where walks are long and
cut short — a table near full, whole windows of tombstones to step past,
budgets of one and two windows, sentinel words as queries, and batches
smaller than a warp's keys.  The retrieve walk writes nothing shared
either (its queries are distinct), so ``cops_retrieve`` /
``cops_retrieve64`` are held bit-exact to ``retrieve_walk_plain`` (counts
and both arenas): in ``run_multi_case`` below, and in
``run_retrieve_case`` — runs of 1, 8 and 40 equal keys in a store near
full, whole windows of tombstones, erased pairs, masks that leave whole
warps' queries inactive, budgets of one and two windows, and a budget past
num_rows on a store with no EMPTY window, so that walks revisit rows.

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

The append kernel walks each run of equal adjacent keys once
(``csrc/cops.cu``), so ``run_multi_case`` lays its batches out in
``LAYOUTS``: runs in a row, runs straddling the kernel's chunks of pairs,
two keys interleaved, shuffled pairs.  ``run_full_case`` adds runs that
meet no other key and go FULL partway: there the kernel must build
exactly the plain version's store.

The bucket list's chain walk writes no shared state, so ``cops_bucket_walk``
is held bit-exact to ``bucket_walk_plain``: both arenas identical, slot by
slot (``run_bucket_case``), and in ``run_chain_case`` on chains grown by
many small batches, so that their buckets are scattered over the pool and
long (the kernel walks several chains a warp, each to its end), with
batches around the kernel's chains a warp and whole warps of inactive
queries; there the arenas must also give each query exactly its key's
values in insertion order.

The read-modify-write (``check_update``: ``cops_update`` and
``cops_update64``, the group-by's and the counting table's):

1. the same live key -> value words map (accumulator and count) when no
   representative reports FULL; otherwise which new keys win a slot
   follows the race, and the maps agree on the keys both hold, a key only
   the kernel holds is one it reports INSERTED, holding its claim value,
   and a key only the plain version holds is one the kernel reports FULL;
2. the same statuses whenever no representative reports FULL; otherwise
   every representative the kernel reports FULL is absent and finds no
   EMPTY / TOMBSTONE lane in any window of its walk within the budget, in
   the store the kernel built;
3. every live key at or before the first EMPTY window of its walk, as for
   the insert;
4. lookup parity on the store it built (``run_update_case`` holds the
   lookup kernel bit-exact to ``lookup_plain`` there).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import bulk, hashing, probing
from repro_torch.core.common import (
    DEFAULT_SEED,
    EMPTY_WORD,
    MASK32,
    STATUS_FULL,
    STATUS_INSERTED,
    TOMBSTONE_WORD,
    as_u32,
    as_word,
)
from repro_torch.core.single_value import key_hash_word
from repro_torch.kernels.cops import ops

LOAD = 0.8      # the multi-value case's target load: Fig. 7's wc-oa
SHARED_WORDS = 1 << 10   # plane-0 words shared by a quarter of the keys
#: the batch layouts of ``run_multi_case`` (``lay_out``)
LAYOUTS = ("runs", "offset", "interleaved", "shuffled")
OFFSET = 3      # "offset": the batch rolled by an odd count of pairs
LAYOUT_SEED = 19   # "shuffled": the permutation's seed
FULL_LOAD = 0.85   # the near-full case's fill, and its budget in windows:
FULL_PROBES = 2
FULL_RUNS = 64     # and the most runs it appends
LOOKUP_LOAD = 0.97      # the lookup case's fill, and the small budgets
LOOKUP_BUDGETS = (1, 2)  # (windows) it walks with beside the table's
RETRIEVE_RUNS = (1, 8, 40)   # the retrieve case's runs of equal keys
CHAIN_ROUNDS = 24    # the chain case's insert batches
CHAIN_LONG = 200     # values of each of its long keys, over every batch


def twin(fn, table_keys):
    """Wrapper ``fn`` of ``ops``, or its two-plane twin (``fn`` + "64")
    for (2, p, W) key planes."""
    return getattr(ops, fn.__name__ + "64") if table_keys.ndim == 3 else fn


def _slot_keys(table_keys, slots):
    """The key batch held at flat ``slots``: (m,) words or (m, kw) planes."""
    kps = ops._planes(table_keys)
    flat = kps.reshape(kps.shape[0], -1)[:, slots]
    return flat[0] if table_keys.ndim == 2 else flat.T.contiguous()


def unpack_keys(words, key_words):
    """Inverse of ``bulk.pack_keys``: the key batch of int64 ``words``."""
    if key_words == 1:
        return as_word(words)
    return torch.stack([as_word(words >> 32), as_word(words)], dim=1)


def _live_slots(table_keys):
    plane0 = ops._planes(table_keys)[0].reshape(-1)
    return torch.nonzero((plane0 != EMPTY_WORD)
                         & (plane0 != TOMBSTONE_WORD)).squeeze(1)


def _tombstone(planes, slots):
    """Write TOMBSTONE into every key plane at the flat ``slots``."""
    kps = ops._planes(planes)
    kps.view(kps.shape[0], -1)[:, slots] = TOMBSTONE_WORD


def _lexsort(keys, values):
    """(keys, values) int64 pairs sorted by key, then by value."""
    order = torch.argsort(values, stable=True)
    order = order[torch.argsort(keys[order], stable=True)]
    return keys[order], values[order]


def _slot_values(table_values, slots):
    """u32 values (int64) at flat ``slots``: (m,) of a (p, W) plane,
    (m, V) of (V, p, W) planes, (m, 0) of None (a hash set)."""
    if table_values is None:
        return slots.new_zeros((slots.shape[0], 0))
    if table_values.ndim == 2:
        return as_u32(table_values.reshape(-1)[slots])
    return as_u32(table_values.reshape(table_values.shape[0], -1)[:, slots].T)


def live_map(table_keys, table_values):
    """(keys, values, slots) of the live slots, sorted by key; keys as
    ``bulk.pack_keys`` words, values as u32 (both int64): (m,) for a
    (p, W) value plane, (m, V) for (V, p, W) planes."""
    slots = _live_slots(table_keys)
    keys = bulk.pack_keys(_slot_keys(table_keys, slots))
    order = torch.argsort(keys)
    return keys[order], _slot_values(table_values, slots[order]), slots[order]


def _same_map(kernel_planes, plain_planes):
    """(part 1, the kernel store's live slots)."""
    kk, kv, kslots = live_map(*kernel_planes)
    pk, pv, _ = live_map(*plain_planes)
    return (bool(kk.shape == pk.shape and torch.equal(kk, pk)
                 and torch.equal(kv, pv)), kslots)


def _before_first_empty(kernel_keys, kslots, kw):
    """Part 3: a plain lookup of every live key finds it at its own slot."""
    _, found, slot = ops.lookup_plain(kernel_keys, None,
                                      _slot_keys(kernel_keys, kslots),
                                      slots=True, **kw)
    return bool(found.all() and torch.equal(slot, kslots))


def check_insert(kernel_planes, plain_planes, kernel_status, plain_status, *,
                 seed, scheme, max_probes) -> dict[str, bool]:
    """Parts 1-3 for one batch; ``*_planes`` are (keys, values) pairs of
    (p, W) int32 tensors after the batch (values None for a hash set).
    Returns ``{part: holds}``."""
    kw = dict(seed=seed, scheme=scheme, max_probes=max_probes)
    same_map, kslots = _same_map(kernel_planes, plain_planes)
    full = bool((kernel_status == STATUS_FULL).any()
                or (plain_status == STATUS_FULL).any())
    same_status = full or bool(torch.equal(kernel_status, plain_status))
    return {"same_map": same_map, "same_status": same_status,
            "before_first_empty": _before_first_empty(kernel_planes[0],
                                                      kslots, kw)}


def check_update(kernel_planes, plain_planes, keys, claim, kernel_status,
                 plain_status, *, seed, scheme, max_probes) -> dict[str, bool]:
    """Parts 1-3 of the read-modify-write for one batch of distinct
    representatives ``keys`` with the values ``claim`` ((m, V) words) that
    each holds after the batch when it claims a slot;
    ``*_planes`` are (key planes, (V, p, W) value planes) after it.
    Returns ``{part: holds}``."""
    kw = dict(seed=seed, scheme=scheme, max_probes=max_probes)
    full = kernel_status == STATUS_FULL
    if not bool(full.any() or (plain_status == STATUS_FULL).any()):
        same_map, kslots = _same_map(kernel_planes, plain_planes)
        same_status = bool(torch.equal(kernel_status, plain_status))
    else:
        kk, kv, kslots = live_map(*kernel_planes)
        pk, pv, _ = live_map(*plain_planes)
        in_p, in_k = torch.isin(kk, pk), torch.isin(pk, kk)
        rk = bulk.pack_keys(keys)
        order = torch.argsort(rk)

        def rep(words):
            at = order[torch.searchsorted(rk[order], words).clamp(
                max=max(rk.shape[0] - 1, 0))]
            return at, bool(torch.equal(rk[at], words))

        only_k, ok_k = rep(kk[~in_p])
        only_p, ok_p = rep(pk[~in_k])
        same_map = (ok_k and ok_p and torch.equal(kv[in_p], pv[in_k])
                    and bool((kernel_status[only_k] == STATUS_INSERTED).all())
                    and torch.equal(kv[~in_p], as_u32(claim[only_k]))
                    and bool((kernel_status[only_p] == STATUS_FULL).all()))
        gone = keys[full]
        absent = not bool(ops.lookup_plain(kernel_planes[0], None, gone,
                                           **kw)[1].any())
        same_status = absent and not bool(
            walk_has_free(kernel_planes[0], gone, **kw).any())
    return {"same_map": bool(same_map), "same_status": same_status,
            "before_first_empty": _before_first_empty(kernel_planes[0],
                                                      kslots, kw)}


def live_pairs(table_keys, table_values):
    """The store's pair multiset: every live slot's (key, value) as two
    int64 tensors (``bulk.pack_keys`` words, u32 values), sorted by key,
    then value."""
    slots = _live_slots(table_keys)
    return _lexsort(bulk.pack_keys(_slot_keys(table_keys, slots)),
                    as_u32(table_values.reshape(-1)[slots]))


def pairs_of(keys, values):
    """A batch's pair multiset, as ``live_pairs`` gives a store's."""
    return _lexsort(bulk.pack_keys(keys), as_u32(values))


def _same(a, b):
    return all(x.shape == y.shape and torch.equal(x, y) for x, y in zip(a, b))


def walk_has_free(table_keys, keys, *, seed, scheme, max_probes):
    """Per key: does a window of its walk within the budget hold an EMPTY
    or TOMBSTONE lane (on plane 0)?"""
    plane0 = ops._planes(table_keys)[0]
    num_rows = plane0.shape[0]
    free_row = ((plane0 == EMPTY_WORD) | (plane0 == TOMBSTONE_WORD)).any(dim=1)
    words = key_hash_word(keys)
    row = probing.initial_row(words, num_rows, seed)
    step = probing.row_step(scheme, words, num_rows, seed)
    found = torch.zeros(keys.shape[:1], dtype=torch.bool, device=keys.device)
    for attempt in range(max_probes):
        found |= free_row[row]
        row = probing.advance_row(row, step, num_rows)
        if attempt % 64 == 63 and bool(found.all()):
            break
    return found


def _walk_pairs(planes, keys, kw):
    """(counts, the (key, value) pairs, sorted, of every slot the plain
    collecting walk of the distinct ``keys`` stamps)."""
    every = torch.ones(keys.shape[:1], dtype=torch.bool, device=keys.device)
    counts, qa, _ = ops.retrieve_walk_plain(planes[0], keys, every,
                                            collect=True, **kw)
    slots = torch.nonzero(qa < keys.shape[0]).squeeze(1)
    return counts, _lexsort(bulk.pack_keys(keys[qa[slots].long()]),
                            as_u32(planes[1].reshape(-1)[slots]))


def check_append(kernel_planes, plain_planes, keys, kernel_status,
                 plain_status, *, seed, scheme, max_probes) -> dict[str, bool]:
    """Parts 1-4 for one appended batch ``keys``; ``*_planes`` are (keys,
    values) pairs of (p, W) int32 tensors after it.  ``{part: holds}``."""
    kw = dict(seed=seed, scheme=scheme, max_probes=max_probes)
    kpairs = live_pairs(*kernel_planes)
    same_pairs = _same(kpairs, live_pairs(*plain_planes))
    full = kernel_status == STATUS_FULL
    if bool(full.any() or (plain_status == STATUS_FULL).any()):
        same_status = not bool(walk_has_free(kernel_planes[0], keys[full],
                                             **kw).any())
    else:
        same_status = torch.equal(kernel_status, plain_status)
    distinct, mult = torch.unique_consecutive(kpairs[0], return_counts=True)
    distinct = unpack_keys(distinct, ops._planes(kernel_planes[0]).shape[0])
    kcounts, kwalk = _walk_pairs(kernel_planes, distinct, kw)
    _, pwalk = _walk_pairs(plain_planes, distinct, kw)
    return {"same_pairs": bool(same_pairs), "same_status": bool(same_status),
            "before_first_empty": torch.equal(kcounts.long(), mult),
            "same_retrieve": _same(kwalk, pwalk)}


def check_walk(table_keys, keys, active, *, seed, scheme, max_probes,
               ) -> dict[str, bool]:
    """``retrieve_walk`` bit-exact against ``retrieve_walk_plain`` on the
    same store: counts only, and counts + both arenas."""
    out = {}
    for collect in (False, True):
        got = twin(ops.retrieve_walk, table_keys)(
            table_keys, keys, active, seed=seed, scheme=scheme,
            max_probes=max_probes, collect=collect)
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
    i = torch.arange(start, start + count + 2, dtype=torch.int64,
                     device=device)
    k = hashing.mix_murmur3(i)
    k = k[k < TOMBSTONE_WORD + 2 ** 32][:count]     # drop EMPTY / TOMBSTONE
    return as_word(k)


def mix64(i: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) u32 values (int64) of a bijective 64-bit mix of the
    non-negative int64 ``i``: three Feistel rounds whose round function is
    murmur3, so distinct inputs give distinct (lo, hi) pairs."""
    left, right = i >> 32, i & MASK32
    for c in (0x243F6A88, 0x85A308D3, 0x13198A2E):
        left, right = right, left ^ hashing.mix_murmur3(right ^ c)
    return right, left


def distinct_keys64(start: int, count: int, device,
                    shared: bool = False) -> torch.Tensor:
    """``count`` distinct two-word keys as (count, 2) int32 planes (plane 0
    the low word): ``mix64`` over ``start, start + 1, ...``, without the
    keys whose plane 0 is a sentinel.

    With ``shared``, every fourth index j = i / 4 instead gives the key
    (plane 0 = 1 + j mod SHARED_WORDS, plane 1 = ~(j / SHARED_WORDS)): a
    quarter of the keys share 2^10 plane-0 words, and the first 2^11 of
    them hold plane-1 words 0xFFFFFFFF and 0xFFFFFFFE, the bits of EMPTY
    and TOMBSTONE.  A kernel that compares plane 0 alone, or that matches
    a key another group has published only on plane 0, then goes wrong.
    The other keys avoid those plane-0 words.  Calls over disjoint index
    ranges give disjoint keys.
    """
    i = torch.arange(start, start + count + 64 + (count >> 16),
                     dtype=torch.int64, device=device)
    lo, hi = mix64(i)
    ok = lo < TOMBSTONE_WORD + 2 ** 32                 # no EMPTY / TOMBSTONE
    if shared:
        sh = i % 4 == 0
        j = i // 4
        ok &= sh | (lo == 0) | (lo > SHARED_WORDS)
        lo = torch.where(sh, 1 + j % SHARED_WORDS, lo)
        hi = torch.where(sh, MASK32 ^ (j // SHARED_WORDS), hi)
    keys = torch.stack([as_word(lo[ok]), as_word(hi[ok])], dim=1)[:count]
    if keys.shape[0] < count:
        raise RuntimeError("distinct_keys64 drew too few keys")
    return keys.contiguous()


def case_keys(key_words: int, count: int, device) -> torch.Tensor:
    """The kernel-vs-plain cases' key pool: ``distinct_keys`` for 1-word
    keys, ``distinct_keys64`` with shared plane-0 words for two."""
    if key_words == 1:
        return distinct_keys(0, count, device)
    return distinct_keys64(0, count, device, shared=True)


def values_for(keys: torch.Tensor, salt: int) -> torch.Tensor:
    """A value word per key ((n,) words or (n, 2) planes)."""
    return as_word(hashing.mix_xxhash(key_hash_word(keys) ^ salt))


def lay_out(keys: torch.Tensor, r: int, layout: str) -> torch.Tensor:
    """The batch of the distinct ``keys`` ((n,) words or (n, 2) planes),
    each ``r`` times, in ``layout``: "runs", each key r times in a row
    (Fig. 7's ``np.repeat``); "offset", that batch rolled by ``OFFSET``
    pairs, so the runs straddle the kernel's aligned chunks; "interleaved",
    keys 2i and 2i + 1 alternating (A B A B ...) for 2r pairs; "shuffled",
    the pairs in a permutation seeded by ``LAYOUT_SEED``."""
    dev = keys.device
    key = torch.arange(keys.shape[0], device=dev).repeat_interleave(r)
    if layout == "offset":
        key = torch.roll(key, OFFSET)
    elif layout == "interleaved":
        copy = torch.arange(r, device=dev).repeat(keys.shape[0])
        key = key[torch.argsort((key // 2) * 2 * r + 2 * copy + key % 2)]
    elif layout == "shuffled":
        gen = torch.Generator().manual_seed(LAYOUT_SEED)
        key = key[torch.randperm(key.shape[0], generator=gen).to(dev)]
    elif layout != "runs":
        raise ValueError(f"layout {layout!r} not in {LAYOUTS}")
    return keys[key]


def table_planes(table):
    """(key planes, value plane) of a table as the wrappers take them."""
    keys = table.store["keys"]
    return (keys[0] if table.key_words == 1 else keys), table.store["values"][0]


def run_case(n: int, *, window: int, scheme: str, device, rho: float = 0.9,
             seed: int = 0x9E3779B9, key_words: int = 1) -> dict[str, bool]:
    """Hold ``cops_insert`` / ``cops_lookup`` (two-word keys:
    ``cops_insert64`` / ``cops_lookup64``; on the CPU, whatever the
    wrappers run) against the plain versions.

    Batch 1 inserts ``n`` distinct keys (``case_keys``) at load ``rho``;
    then 1/8 of them are erased (tombstones), and batch 2 — n/4 elements,
    half present keys with new values, half new keys, 1/8 in-batch
    duplicates, 1/16 masked — is deduped and upserted onto that store.
    After each batch: contract parts 1-3, and the lookup on the
    kernel-built store, bit-exact against ``lookup_plain`` for present and
    absent keys.
    """
    from repro_torch.core import single_value
    table = single_value.create(int(n / rho), window=window, scheme=scheme,
                                seed=seed, device=device, key_words=key_words)
    budget = bulk._tstatic(table)[3]
    kw = dict(seed=seed, scheme=scheme, max_probes=budget)
    kernel = table_planes(table)
    plain = tuple(t.clone() for t in kernel)
    insert, lookup = twin(ops.insert, kernel[0]), twin(ops.lookup, kernel[0])
    m = n // 8
    pool = case_keys(key_words, n + n // 8 + m, device)
    keys, absent, new = pool[:n], pool[n:n + n // 8], pool[n + n // 8:]
    checks = {}

    def upsert(rkeys, rvals, count, tag):
        ks = insert(*kernel, rkeys, rvals, count=count, **kw)
        ps = ops.insert_plain(*plain, rkeys, rvals, count=count, **kw)
        for part, ok in check_insert(kernel, plain, ks, ps, **kw).items():
            checks[f"{tag}_{part}"] = ok
        queries = torch.cat([rkeys, absent])
        got = lookup(*kernel, queries, slots=True, **kw)
        want = ops.lookup_plain(*kernel, queries, slots=True, **kw)
        checks[f"{tag}_lookup_exact"] = all(torch.equal(a, b)
                                            for a, b in zip(got, want))
        return int((ks == 0).sum())

    count = upsert(keys, values_for(keys, 1), 0, "batch1")
    gone = keys[: n // 8]
    for planes in (kernel, plain):
        _, found, slot = ops.lookup_plain(*planes, gone, slots=True, **kw)
        _tombstone(planes[0], slot[found])
    count -= gone.shape[0]
    batch = torch.cat([keys[n // 8: n // 8 + m], new])
    dups = batch.shape[0] // 8
    batch[-dups:] = batch[:dups]                     # in-batch duplicates
    live = torch.arange(batch.shape[0], device=device) % 16 != 5
    rkeys, rvals, _ = bulk.dedup(batch, values_for(batch, 2), live)
    upsert(rkeys, rvals, count, "batch2")
    return checks


def run_insert_race_case(*, window: int, device, key_words: int = 1,
                         values: bool = True, rounds: int = 60,
                         batch: int | None = None, rows: int = 13,
                         seed: int = 0x9E3779B9) -> dict[str, bool]:
    """Hold ``cops_insert`` / ``cops_insert64`` (on the CPU, whatever the
    wrapper runs) against ``insert_plain`` where their claims race: every
    key starts its walk on row 0 of a table of ``rows`` rows (with
    ``values`` False a hash set: no value plane).

    Each of ``rounds`` rounds starts from an empty table and upserts two
    overlapping batches of distinct keys (``case_keys``), in a new order
    each round: by default the first half of up to rows * W / 2 such keys,
    then the last three quarters, so that the second batch's first third
    is present (its values are stored) while its other keys race one
    another for row 0's lanes and the rows after it; with ``batch``, the
    first ``batch`` keys, then ``batch`` keys from the middle of those.
    On alternate rounds the last quarter of the first batch is erased
    before the second (tombstones, which the second batch re-inserts).
    After each batch contract parts 1-3 (``check_insert``) and the lookup
    of the batch and of absent keys on the kernel-built store, bit-exact
    against ``lookup_plain``.  Returns ``{f"batch{b}_{part}": holds in
    every round}``.
    """
    from repro_torch.core import single_value

    def fresh():
        t = single_value.create(rows * window, window=window, seed=seed,
                                device=device, key_words=key_words)
        planes = table_planes(t)
        return t, (planes[0], planes[1] if values else None)

    t, (table_keys, _) = fresh()
    kw = dict(seed=seed, scheme=t.scheme, max_probes=bulk._tstatic(t)[3])
    insert, lookup = twin(ops.insert, table_keys), twin(ops.lookup, table_keys)
    pool = case_keys(key_words, 1 << 16, device)
    on0 = probing.initial_row(key_hash_word(pool), t.num_rows, seed) == 0
    same, absent = pool[on0][: t.num_rows * window // 2], pool[~on0][:64]
    n = same.shape[0]
    checks = {"enough_keys": n >= (3 * batch // 2 if batch else 4)}
    gen = torch.Generator(device=device)
    gen.manual_seed(2 * window + key_words)

    def note(tag, parts):
        for part, ok in parts.items():
            checks[f"{tag}_{part}"] = checks.get(f"{tag}_{part}", True) and ok

    for rnd in range(rounds):
        t, kernel = fresh()
        plain = tuple(None if x is None else x.clone() for x in kernel)
        keys = same[torch.randperm(n, generator=gen, device=device)]
        if batch:
            first, second = keys[:batch], keys[batch // 2: batch // 2 + batch]
        else:
            first, second = keys[: n // 2], keys[n // 4:]
        count = 0
        for step, bk in enumerate((first, second)):
            tag = f"batch{step + 1}"
            v = values_for(bk, 2 * rnd + step) if values else None
            ks = insert(*kernel, bk, v, count=count, **kw)
            ps = ops.insert_plain(*plain, bk, v, count=count, **kw)
            note(tag, check_insert(kernel, plain, ks, ps, **kw))
            queries = torch.cat([bk, absent])
            got = lookup(*kernel, queries, slots=True, **kw)
            want = ops.lookup_plain(*kernel, queries, slots=True, **kw)
            note(tag, {"lookup_exact": all(
                (a is None and b is None) or torch.equal(a, b)
                for a, b in zip(got, want))})
            count += int((ks == STATUS_INSERTED).sum())
            if step == 0 and rnd % 2:
                gone = first[first.shape[0] * 3 // 4:]
                for planes in (kernel, plain):
                    _, f, slot = ops.lookup_plain(planes[0], None, gone,
                                                  slots=True, **kw)
                    _tombstone(planes[0], slot[f])
                count = _live_slots(kernel[0]).shape[0]
    return checks


def _sentinel_queries(key_words: int, device) -> torch.Tensor:
    """Queries made of the sentinel words: EMPTY and TOMBSTONE as 1-word
    keys; as two-word keys, either one on plane 0 with EMPTY, TOMBSTONE or
    0 on plane 1."""
    s = torch.tensor([EMPTY_WORD, TOMBSTONE_WORD], dtype=torch.int64)
    if key_words == 2:
        hi = torch.tensor([EMPTY_WORD, TOMBSTONE_WORD, 0], dtype=torch.int64)
        s = torch.stack([s.repeat_interleave(3), hi.repeat(2)], dim=1)
    return as_word(s).to(device)


def _passes_tombstones(planes, keys, found, slot, *, seed, scheme,
                       max_probes):
    """Does the walk of a found key read a window that holds only
    TOMBSTONEs before the window of its match?"""
    plane0 = ops._planes(planes)[0]
    num_rows, window = plane0.shape
    dead = (plane0 == TOMBSTONE_WORD).all(dim=1)
    words = key_hash_word(keys)
    row = probing.initial_row(words, num_rows, seed)
    step = probing.row_step(scheme, words, num_rows, seed)
    walking = found.clone()
    target = torch.where(found, slot // window, -1)
    passed = torch.zeros_like(found)
    for _ in range(max_probes):
        walking &= row != target
        passed |= walking & dead[row]
        if not bool(walking.any()):
            break
        row = probing.advance_row(row, step, num_rows)
    return passed


def run_lookup_case(*, window: int, scheme: str = "cops", device,
                    key_words: int = 1, capacity: int = 1 << 12,
                    batch: int | None = None,
                    seed: int = 0x9E3779B9) -> dict[str, bool]:
    """Hold ``cops_lookup`` / ``cops_lookup64`` (on the CPU, whatever the
    wrapper runs) bit-exact against ``lookup_plain`` — values, found and
    slots — where walks are long and cut short.

    A table of ``capacity`` slots is filled by ``insert_plain`` to
    ``LOOKUP_LOAD`` of its capacity (keys that find no free lane within the
    budget stay out); then every third row that holds no EMPTY lane is
    tombstoned whole (a window of TOMBSTONEs only, which a walk steps
    past), and one in eight of the other keys is erased.  The queries:
    every key of the fill (present, erased or left out), as many absent
    keys, and ``_sentinel_queries``; with ``batch``, only ``batch`` keys,
    a present key and an absent one in turn.  Each is looked up with the
    table's budget and with budgets of ``LOOKUP_BUDGETS`` windows, on a
    value plane and on none (a hash set), with slots and without.

    Returns ``{check: holds}``: each lookup bit-exact (``exact_*``); and,
    without ``batch``, that the case reaches what it is for: a walk that
    steps past a TOMBSTONE-only window to its match, a walk that a small
    budget ends before the match the table's budget finds, a sentinel
    query that is found.
    """
    from repro_torch.core import single_value
    table = single_value.create(capacity, window=window, scheme=scheme,
                                seed=seed, device=device, key_words=key_words)
    planes = table_planes(table)
    budget = bulk._tstatic(table)[3]
    n = int(table.capacity * LOOKUP_LOAD)
    pool = case_keys(key_words, 2 * n, device)
    keys, absent = pool[:n], pool[n:]
    ops.insert_plain(*planes, keys, values_for(keys, 1), count=0,
                     seed=seed, scheme=scheme, max_probes=budget)
    plane0 = ops._planes(planes[0])[0]
    full_rows = torch.nonzero(~(plane0 == EMPTY_WORD).any(dim=1)).squeeze(1)
    dead = full_rows[::3]
    slots = (dead[:, None] * window
             + torch.arange(window, device=device)).reshape(-1)
    _tombstone(planes[0], slots)
    _, found, slot = ops.lookup_plain(planes[0], None, keys[::8], slots=True,
                                      seed=seed, scheme=scheme,
                                      max_probes=budget)
    _tombstone(planes[0], slot[found])
    if batch:
        live = ops.lookup_plain(planes[0], None, keys, seed=seed,
                                scheme=scheme, max_probes=budget)[1]
        pick = torch.stack([keys[live][:batch], absent[:batch]], dim=1)
        queries = pick.reshape(-1, *keys.shape[1:])[:batch]
    else:
        sentinels = _sentinel_queries(key_words, device)
        queries = torch.cat([keys, absent, sentinels])
    lookup = twin(ops.lookup, planes[0])
    checks = {}
    for probes in (budget, *LOOKUP_BUDGETS):
        kw = dict(seed=seed, scheme=scheme, max_probes=probes)
        for values in (planes[1], None):
            for with_slots in (True, False):
                got = lookup(planes[0], values, queries, slots=with_slots,
                             **kw)
                want = ops.lookup_plain(planes[0], values, queries,
                                        slots=with_slots, **kw)
                tag = (f"exact_b{probes}_"
                       f"{'set' if values is None else 'values'}_"
                       f"{'slots' if with_slots else 'noslots'}")
                checks[tag] = all(
                    (a is None and b is None) or (
                        a is not None and b is not None and torch.equal(a, b))
                    for a, b in zip(got, want))
    if batch:
        return checks
    kw = dict(seed=seed, scheme=scheme)
    _, found, slot = ops.lookup_plain(planes[0], None, queries, slots=True,
                                      max_probes=budget, **kw)
    short = ops.lookup_plain(planes[0], None, queries,
                             max_probes=LOOKUP_BUDGETS[0], **kw)[1]
    checks["reaches_past_tombstones"] = bool(_passes_tombstones(
        planes[0], queries, found, slot, max_probes=budget, **kw).any())
    checks["reaches_the_budget"] = bool((found & ~short).any())
    checks["reaches_a_sentinel"] = bool(found[-sentinels.shape[0]:].any())
    return checks


def run_plen_case(*, window: int, scheme: str = "cops", device,
                  key_words: int = 1, capacity: int = 1 << 12,
                  load: float = LOOKUP_LOAD, revisit: bool = True,
                  batch: int | None = None,
                  seed: int = DEFAULT_SEED) -> dict[str, bool]:
    """Hold the lookups' probe lengths (``plen=True``: the ``PLEN``
    instantiations of ``cops_lookup`` / ``cops_lookup64``, on the CPU
    whatever the wrapper runs) bit-exact against ``lookup_plain``'s, and
    the lookup's values, found and slots unchanged by them.

    A table of ``capacity`` slots is filled through ``ops.insert`` to
    ``load`` of its capacity (keys that find no free lane within the
    budget stay out); then every third row that holds no EMPTY lane is
    tombstoned whole, and one in eight of the other keys is erased.  The
    queries: every key of the fill, as many absent keys, and
    ``_sentinel_queries``; with ``batch``, only ``batch`` keys, a present
    key and an absent one in turn.  Each is looked up with the table's
    budget and with budgets of ``LOOKUP_BUDGETS`` windows, on a value
    plane and on none; with ``revisit``, also with a budget of num_rows +
    3 on a copy of the store whose EMPTY slots are TOMBSTONEs ("rows3":
    the kernel stops reading at num_rows and reports the budget, as the
    plain walk does after revisiting rows), there for at most 64 absent
    keys beside the present ones, since each absent walk reads the whole
    table.

    Returns ``{check: holds}``: ``exact_{budget}_{values|set}`` (values,
    found, slots and probe lengths equal to ``lookup_plain``'s),
    ``same_{budget}_{values|set}`` (values, found and slots equal to the
    lookup's without ``plen``); and, without ``batch``, that the case
    reaches what it is for: a walk of more than two windows, a walk that
    steps past a TOMBSTONE-only window to its match, a walk that a budget
    of one window cuts, and (``revisit``) a walk that reports num_rows + 3.
    """
    from repro_torch.core import single_value
    table = single_value.create(capacity, window=window, scheme=scheme,
                                seed=seed, device=device, key_words=key_words)
    planes = table_planes(table)
    budget = bulk._tstatic(table)[3]
    n = int(table.capacity * load)
    pool = case_keys(key_words, 2 * n, device)
    keys, absent = pool[:n], pool[n:]
    kw = dict(seed=seed, scheme=scheme)
    twin(ops.insert, planes[0])(*planes, keys, values_for(keys, 1), count=0,
                                max_probes=budget, **kw)
    plane0 = ops._planes(planes[0])[0]
    full_rows = torch.nonzero(~(plane0 == EMPTY_WORD).any(dim=1)).squeeze(1)
    dead = full_rows[::3]
    _tombstone(planes[0], (dead[:, None] * window
                           + torch.arange(window, device=device)).reshape(-1))
    _tombstone(planes[0], _live_slots(planes[0])[::8])
    if batch:
        pick = torch.stack([keys[:batch], absent[:batch]], dim=1)
        queries = pick.reshape(-1, *keys.shape[1:])[:batch]
    else:
        queries = torch.cat([keys, absent,
                             _sentinel_queries(key_words, device)])
    walks = ([("table", planes[0], queries, budget)]
             + [(f"b{b}", planes[0], queries, b) for b in LOOKUP_BUDGETS])
    if revisit:
        closed = planes[0].clone()
        flat0 = ops._planes(closed)[0].reshape(-1)
        _tombstone(closed, torch.nonzero(flat0 == EMPTY_WORD).squeeze(1))
        few = (queries if batch
               else torch.cat([keys, absent[:64]]))
        walks.append(("rows3", closed, few, table.num_rows + 3))
    lookup = twin(ops.lookup, planes[0])

    def same(a, b):
        return all((x is None and y is None) or (
            x is not None and y is not None and torch.equal(x, y))
            for x, y in zip(a, b))

    checks, plain = {}, {}
    for label, store, qs, probes in walks:
        # one plain walk serves both planes: without a value plane the
        # lookup returns no values and the same found, slots and lengths
        want = ops.lookup_plain(store, planes[1], qs, slots=True, plen=True,
                                max_probes=probes, **kw)
        plain[label] = want
        for values in (planes[1], None):
            tag = f"{label}_{'set' if values is None else 'values'}"
            got = lookup(store, values, qs, slots=True, plen=True,
                         max_probes=probes, **kw)
            base = lookup(store, values, qs, slots=True, max_probes=probes,
                          **kw)
            checks[f"exact_{tag}"] = same(
                got, want if values is not None else (None, *want[1:]))
            checks[f"same_{tag}"] = same(got[:3], base)
    if batch:
        return checks
    _, found, slot, lengths = plain["table"]
    checks["reaches_a_long_walk"] = bool((lengths > 2).any())
    checks["reaches_past_tombstones"] = bool(_passes_tombstones(
        planes[0], queries, found, slot, max_probes=budget, **kw).any())
    checks["reaches_the_budget"] = bool(
        (plain[f"b{LOOKUP_BUDGETS[0]}"][3] < lengths).any())
    if revisit:
        checks["reaches_a_revisit"] = bool(
            (plain["rows3"][3] == table.num_rows + 3).any())
    return checks


def _matches_past_tombstones(planes, keys, *, seed, scheme, max_probes):
    """Does the retrieve walk of each key match in a window after one that
    holds only TOMBSTONEs?"""
    kps = ops._planes(planes)
    num_rows = kps.shape[1]
    dead = (kps[0] == TOMBSTONE_WORD).all(dim=1)
    key = bulk._key_cols(keys)
    words = key_hash_word(keys)
    row = probing.initial_row(words, num_rows, seed)
    step = probing.row_step(scheme, words, num_rows, seed)
    walking = torch.ones(key.shape[:1], dtype=torch.bool, device=key.device)
    passed = torch.zeros_like(walking)
    after = torch.zeros_like(walking)
    for _ in range(max_probes):
        win, match = bulk.window_match(kps, row, key)
        after |= walking & passed & match.any(dim=1)
        passed |= walking & dead[row]
        walking &= ~(win == EMPTY_WORD).any(dim=1)
        if not bool(walking.any()):
            break
        row = probing.advance_row(row, step, num_rows)
    return after


def run_retrieve_case(*, window: int, scheme: str = "cops", device,
                      key_words: int = 1, capacity: int = 1 << 12,
                      batch: int | None = None,
                      seed: int = DEFAULT_SEED) -> dict[str, bool]:
    """Hold ``cops_retrieve`` / ``cops_retrieve64`` (on the CPU, whatever
    the wrapper runs) bit-exact against ``retrieve_walk_plain`` — the
    counts, and collecting, both arenas slot for slot — where walks are
    long and cut short.

    A multi-value table of ``capacity`` slots is filled by ``append_plain``
    to ``LOOKUP_LOAD`` of its capacity with distinct keys (``case_keys``)
    in runs of ``RETRIEVE_RUNS`` equal keys in turn, so that a run spans
    windows and 32-lane chunks (pairs that find no free lane stay out);
    then every third row that holds no EMPTY lane is tombstoned whole (a
    window of TOMBSTONEs only, which a walk steps past), and one in eight
    of the other pairs is erased.  The queries: every key of the fill, as
    many absent keys, and ``_sentinel_queries``; with ``batch``, only
    ``batch`` keys, a present key and an absent one in turn.  Each walk
    runs under two masks, every query active ("all") and whole groups of 8
    queries inactive beside one in five others ("groups"), counts only and
    collecting, with the table's budget ("table"), with budgets of
    ``LOOKUP_BUDGETS`` windows ("b1", "b2"), and with a budget of
    num_rows + 3 windows on a copy of the store whose EMPTY slots are
    TOMBSTONEs ("rows3": no walk stops early, and each comes back to rows
    it has read, which it counts and stamps again).

    Returns ``{check: holds}``: each walk bit-exact
    (``exact_{budget}_{mask}_{counts|collect}``); and, without ``batch``,
    that the case reaches what it is for: a walk that matches past a
    TOMBSTONE-only window, a walk that a budget of one window cuts, and a
    walk that counts a row it revisits.
    """
    from repro_torch.core import multi_value
    table = multi_value.create(capacity, window=window, scheme=scheme,
                               seed=seed, device=device, key_words=key_words)
    planes = table_planes(table)
    budget = bulk._tstatic(table)[3]
    n = int(table.capacity * LOOKUP_LOAD)
    nk = len(RETRIEVE_RUNS) * (n // sum(RETRIEVE_RUNS) + 1)
    pool = case_keys(key_words, 2 * nk, device)
    keys, absent = pool[:nk], pool[nk:]
    runs = torch.tensor(RETRIEVE_RUNS, device=device).repeat(
        nk // len(RETRIEVE_RUNS))
    fill = keys.repeat_interleave(runs, dim=0)[:n]
    kw = dict(seed=seed, scheme=scheme)
    ops.append_plain(*planes, fill,
                     torch.arange(n, dtype=torch.int32, device=device),
                     max_probes=budget, **kw)
    plane0 = ops._planes(planes[0])[0]
    full_rows = torch.nonzero(~(plane0 == EMPTY_WORD).any(dim=1)).squeeze(1)
    dead = full_rows[::3]
    _tombstone(planes[0], (dead[:, None] * window
                           + torch.arange(window, device=device)).reshape(-1))
    _tombstone(planes[0], _live_slots(planes[0])[::8])
    closed = planes[0].clone()
    flat0 = ops._planes(closed)[0].reshape(-1)
    _tombstone(closed, torch.nonzero(flat0 == EMPTY_WORD).squeeze(1))
    if batch:
        pick = torch.stack([keys[:batch], absent[:batch]], dim=1)
        queries = pick.reshape(-1, *keys.shape[1:])[:batch]
    else:
        queries = torch.cat([keys, absent,
                             _sentinel_queries(key_words, device)])
    i = torch.arange(queries.shape[0], device=device)
    masks = {"all": torch.ones_like(i, dtype=torch.bool),
             "groups": ((i // 8) % 3 != 1) & (i % 5 != 2)}
    walks = ([("table", planes[0], budget)]
             + [(f"b{b}", planes[0], b) for b in LOOKUP_BUDGETS]
             + [("rows3", closed, table.num_rows + 3)])
    checks = {}
    for label, store, probes in walks:
        for name, active in masks.items():
            for mode, ok in check_walk(store, queries, active,
                                       max_probes=probes, **kw).items():
                checks[f"exact_{label}_{name}_{mode}"] = ok
    if batch:
        return checks

    def counts(store, probes):
        return ops.retrieve_walk_plain(store, queries, masks["all"],
                                       max_probes=probes, collect=False,
                                       **kw)[0]

    checks["reaches_past_tombstones"] = bool(_matches_past_tombstones(
        planes[0], queries, max_probes=budget, **kw).any())
    checks["reaches_the_budget"] = bool(
        (counts(planes[0], budget) > counts(planes[0], LOOKUP_BUDGETS[0]))
        .any())
    checks["reaches_a_revisit"] = bool(
        (counts(closed, table.num_rows + 3) > counts(closed, table.num_rows))
        .any())
    return checks


#: the read-modify-writes the cases drive: name -> (fold, operands: the
#: element's value or 1 in plane 0 and 1 in plane 1, or "high", a value of
#: at least 2^31 in both planes); the group-by's aggregates carry (operand,
#: 1) per element, the counting table 1; "saturating" makes a group's rows
#: saturate the counter and wrap the sum, so a claim saturates through
#: its other rows only
UPDATES = {"sum": (("add", "add"), "value"),
           "mean": (("add", "add"), "value"),
           "count": (("add", "add"), "one"),
           "min": (("min", "add"), "value"),
           "max": (("max", "add"), "value"),
           "counting": (("sat_add",), "one"),
           "saturating": (("sat_add", "add"), "high")}


def update_batch(keys, salt, what):
    """(n, V) operands of ``UPDATES[what]`` for the batch ``keys``: a
    value word per element (``values_for``) or 1 in plane 0, 1 in plane
    1; or for "high", values of at least 2^31 in both planes."""
    fold, operand = UPDATES[what]
    n, dev = keys.shape[0], keys.device
    if operand == "high":
        top = as_word(torch.tensor(1 << 31, device=dev))
        return torch.stack([values_for(keys, salt) | top,
                            values_for(keys, salt + 1) | top], dim=1)
    ones = torch.ones((n,), dtype=torch.int32, device=dev)
    first = values_for(keys, salt) if operand == "value" else ones
    return torch.stack([first, ones][:len(fold)], dim=1)


def run_update_case(n: int, *, window: int, scheme: str, device,
                    what: str = "sum", groups: int | None = None,
                    rho: float = 0.9, key_words: int = 1,
                    cover: bool = False,
                    seed: int = 0x9E3779B9) -> dict[str, bool]:
    """Hold ``cops_update`` (two-word keys: ``cops_update64``; on the CPU,
    whatever the wrapper runs) against ``update_plain``, and
    ``cops_lookup`` / ``cops_lookup64`` against ``lookup_plain`` on the
    store it builds, for the read-modify-write ``what`` of ``UPDATES``.

    Batch 1: ``n`` elements over ``groups`` distinct keys (``case_keys``,
    default n / 4; groups / ``rho`` slots, so ``rho`` > 1 fills the table
    and reports FULL), 1/16 masked, through the torch front end
    (``bulk.update_front``: one representative per key, the other rows
    folded into its slot); with ``cover`` every one of the groups in a
    live row, so that batch 1 has exactly ``groups`` representatives
    (checked as ``batch1_covers``).  Then 1/8 of the
    groups are erased (tombstones); for ``"counting"`` 64 counters are set
    to 0xFFFFFFF0.  Batch 2: n/4 elements, half of present groups, half
    drawn from groups / 8 new keys (and for ``"counting"`` each of those
    64 keys 32 times, so they saturate).
    After each batch: contract parts 1-3 (``check_update``), the live count
    and the lookup of the representatives and of absent keys, bit-exact;
    after a batch that reported FULL the plain store restarts from the
    kernel's;
    for ``"counting"``, the present ones of the 64 saturated.
    """
    from repro_torch.core import single_value
    fold = UPDATES[what][0]
    vw = len(fold)
    groups = groups or max(16, n // 4)
    table = single_value.create(int(groups / rho), window=window,
                                scheme=scheme, seed=seed, device=device,
                                key_words=key_words, value_words=vw)
    kw = dict(seed=seed, scheme=scheme, max_probes=bulk._tstatic(table)[3])
    kernel = (table_planes(table)[0], table.store["values"])
    plain = tuple(t.clone() for t in kernel)
    update, lookup = twin(ops.update, kernel[0]), twin(ops.lookup, kernel[0])
    eighth = max(1, groups // 8)
    pool = case_keys(key_words, groups + 2 * eighth, device)
    keys, absent = pool[:groups], pool[groups:groups + eighth]
    new = pool[groups + eighth:]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    checks = {}
    count = 0

    def rmw(tag, batch, live):
        nonlocal count
        vals = update_batch(batch, len(checks), what)
        rkeys, x, claim, rest, _ = bulk.update_front(batch, vals, vals, live)
        more = () if rest is None else (rest, vals)
        ks = update(*kernel, rkeys, x, claim, *more, ops=fold, count=count,
                    **kw)
        ps = ops.update_plain(*plain, rkeys, x, claim, *more, ops=fold,
                              count=count, **kw)
        if rest is not None:    # what a new key holds after its group
            claim = bulk.fold_words(fold, claim, bulk.fold_rest(
                fold, rest, vals, rkeys.shape[0]))
        for part, ok in check_update(kernel, plain, rkeys, claim, ks, ps,
                                     **kw).items():
            checks[f"{tag}_{part}"] = ok
        count += int((ks == STATUS_INSERTED).sum())
        checks[f"{tag}_count"] = count == _live_slots(kernel[0]).shape[0]
        if bool((ks == STATUS_FULL).any()):
            # which keys won a slot followed the race: the next batch
            # starts both from the kernel's store
            for a, b in zip(plain, kernel):
                a.copy_(b)
        queries = torch.cat([rkeys, absent])
        plane = kernel[1][0] if vw == 1 else None
        got = lookup(kernel[0], plane, queries, slots=True, **kw)
        want = ops.lookup_plain(kernel[0], plane, queries, slots=True, **kw)
        checks[f"{tag}_lookup_exact"] = all(
            (a is None and b is None) or torch.equal(a, b)
            for a, b in zip(got, want))

    pick = torch.randint(0, groups, (n,), generator=gen, device=device)
    live = torch.arange(n, device=device) % 16 != 5
    if cover:
        every = torch.nonzero(live).squeeze(1)[:groups]
        if every.shape[0] < groups:
            raise ValueError(f"{n} rows cannot cover {groups} groups")
        pick[every] = torch.randperm(groups, generator=gen,
                                     device=device)
        checks["batch1_covers"] = (torch.unique(pick[live]).shape[0]
                                   == groups)
    rmw("batch1", keys[pick], live)
    gone = keys[: groups // 8]
    hot = keys[groups // 8: groups // 8 + 64]
    hot = hot[ops.lookup_plain(kernel[0], None, hot, **kw)[1]]   # present
    for planes in (kernel, plain):
        _, found, slot = ops.lookup_plain(planes[0], None, gone, slots=True,
                                          **kw)
        _tombstone(planes[0], slot[found])
        if what == "counting":
            slot = ops.lookup_plain(planes[0], None, hot, slots=True, **kw)[2]
            planes[1].view(-1)[slot] = as_word(
                torch.tensor(0xFFFFFFF0, device=device))
    count = _live_slots(kernel[0]).shape[0]
    m = max(2, n // 8)
    pick = torch.randint(groups // 8, groups, (m,), generator=gen,
                         device=device)
    fresh = torch.randint(0, eighth, (m,), generator=gen, device=device)
    batch = torch.cat([keys[pick], new[fresh]])
    if what == "counting":
        batch = torch.cat([hot.repeat_interleave(32, dim=0), batch])
    rmw("batch2", batch, None)
    if what == "counting":
        got, found, _ = ops.lookup_plain(kernel[0], kernel[1][0], hot, **kw)
        checks["saturated"] = bool(found.all() and hot.shape[0] > 0 and (
            as_u32(got) == 0xFFFFFFFF).all())
    return checks


def run_multi_case(n: int, *, window: int, scheme: str, device, r: int = 8,
                   max_probes: int | None = None, key_words: int = 1,
                   layout: str = "runs") -> dict[str, bool]:
    """Hold ``cops_append`` / ``cops_retrieve`` (two-word keys:
    ``cops_append64`` / ``cops_retrieve64``; on the CPU, whatever the
    wrappers run) against the plain versions.

    Batch 1 appends ``n`` pairs at load ``LOAD``: ``n / r`` distinct keys
    (``case_keys``; two-word keys sorted by plane 0, so that keys sharing
    their low word sit side by side), each repeated ``r`` times, laid out
    as ``layout`` says (``lay_out``; "runs" is Fig. 7's layout), values
    ``0 .. n-1`` in batch order.  Then 1/8 of the keys are erased through
    ``multi_value.erase`` (tombstones), and batch 2 — n/8 pairs, half new
    pairs of present keys, half new keys — is appended onto that store.
    After each batch: contract parts 1-4, the live count, and the walk on
    the kernel-built store, bit-exact against ``retrieve_walk_plain``
    (counts only and collecting) for present and absent keys, a batch
    holding duplicates and a masked batch.
    """
    from repro_torch.core import bulk_retrieve, multi_value
    ktab = multi_value.create(int(n / LOAD), window=window, scheme=scheme,
                              max_probes=max_probes, device=device,
                              key_words=key_words)
    ptab = dataclasses.replace(
        ktab, store={k: v.clone() for k, v in ktab.store.items()})
    kw = dict(seed=DEFAULT_SEED, scheme=scheme,
              max_probes=bulk._tstatic(ktab)[3])
    append_fn = twin(ops.append, table_planes(ktab)[0])
    nk = max(16, n // r)
    pool = case_keys(key_words, nk + nk // 8 + nk // 16, device)
    base, absent, new = pool[:nk], pool[nk:nk + nk // 8], pool[nk + nk // 8:]
    if key_words == 2:
        base = base[torch.argsort(base[:, 0], stable=True)]
    checks = {}

    def walks(tag, queries):
        dup = torch.cat([queries[: nk // 4], queries[: nk // 4]])
        masked = torch.arange(queries.shape[0], device=device) % 3 != 0
        for name, q, live in (("present_absent", torch.cat([queries, absent]),
                               None),
                              ("duplicates", dup, None),
                              ("masked", queries, masked)):
            live = (torch.ones(q.shape[:1], dtype=torch.bool, device=device)
                    if live is None else live)
            reps, _ = bulk_retrieve.group_queries(q, live)
            for mode, ok in check_walk(table_planes(ktab)[0], q, reps,
                                       **kw).items():
                checks[f"{tag}_walk_{name}_{mode}"] = ok

    def append(tag, keys, start):
        nonlocal ktab, ptab
        vals = torch.arange(start, start + keys.shape[0], dtype=torch.int32,
                            device=device)
        ks = append_fn(*table_planes(ktab), keys, vals, **kw)
        ps = ops.append_plain(*table_planes(ptab), keys, vals, **kw)
        for part, ok in check_append(table_planes(ktab), table_planes(ptab),
                                     keys, ks, ps, **kw).items():
            checks[f"{tag}_{part}"] = ok
        ktab = dataclasses.replace(
            ktab, count=ktab.count + int((ks == STATUS_INSERTED).sum()))
        checks[f"{tag}_count"] = (
            ktab.count == live_pairs(*table_planes(ktab))[0].shape[0])

    append("batch1", lay_out(base, r, layout), 0)
    walks("batch1", base)
    gone = base[: nk // 8]
    ktab, erased = multi_value.erase(ktab, gone)
    every = torch.ones(gone.shape[:1], dtype=torch.bool, device=device)
    pcnt, pqa, _ = ops.retrieve_walk_plain(table_planes(ptab)[0], gone, every,
                                           collect=True, **kw)
    ptab.ops.tombstone_slots(ptab.store,
                             torch.nonzero(pqa < gone.shape[0]).squeeze(1))
    checks["erase_counts"] = torch.equal(erased, pcnt)
    checks["erase_same_pairs"] = _same(live_pairs(*table_planes(ktab)),
                                       live_pairs(*table_planes(ptab)))
    half = nk // 16
    batch2 = torch.cat([base[nk // 8: nk // 8 + half], new[:half]])
    append("batch2", lay_out(batch2, r, layout), n)
    walks("batch2", torch.cat([base, new[:half]]))
    return checks


def run_full_case(n: int, *, window: int, scheme: str, device,
                  key_words: int = 1) -> dict[str, bool]:
    """Hold ``cops_append`` (``cops_append64``) to ``append_plain`` where
    runs go FULL partway.

    A multi-value table of capacity ~n with a budget of ``FULL_PROBES``
    windows is filled by ``append_plain`` with ``FULL_LOAD`` x capacity
    distinct keys, one pair each (some go FULL; both stores alike).  Then
    one batch appends runs of G = min(W, 32) pairs (the kernel's chunk, so
    a run is one group's) of new keys whose walks hold between 1 and G - 1
    free lanes and share no window with another run's walk, at most
    ``FULL_RUNS`` of them.  No run meets another key, so the kernel must
    place exactly what the plain version places: the first pairs of each
    run in its free lanes, in walk and lane order, the rest FULL.  Checks:
    contract parts 1-4, the same statuses and the same planes, and that
    the case holds runs that went FULL partway.  Needs W >= 2 (at W = 1 a
    run is one pair).
    """
    from repro_torch.core import multi_value
    if window < 2:
        raise ValueError("a run of W = 1 is one pair: it cannot go FULL "
                         "partway")
    ktab = multi_value.create(n, window=window, scheme=scheme,
                              max_probes=FULL_PROBES, device=device,
                              key_words=key_words)
    kw = dict(seed=DEFAULT_SEED, scheme=scheme,
              max_probes=bulk._tstatic(ktab)[3])
    g = min(window, 32)
    nfill = int(FULL_LOAD * ktab.capacity)
    ncand = max(4 * FULL_RUNS, ktab.num_rows)
    pool = case_keys(key_words, nfill + ncand, device)
    fill, cand = pool[:nfill], pool[nfill:]
    ops.append_plain(*table_planes(ktab), fill,
                     torch.arange(nfill, dtype=torch.int32, device=device),
                     **kw)
    ptab = dataclasses.replace(
        ktab, store={k: v.clone() for k, v in ktab.store.items()})
    plane0 = ops._planes(table_planes(ktab)[0])[0]
    free = ((plane0 == EMPTY_WORD) | (plane0 == TOMBSTONE_WORD)).sum(1)
    words = key_hash_word(cand)
    rows = [probing.initial_row(words, ktab.num_rows, kw["seed"])]
    step = probing.row_step(scheme, words, ktab.num_rows, kw["seed"])
    for _ in range(1, kw["max_probes"]):
        rows.append(probing.advance_row(rows[-1], step, ktab.num_rows))
    rows = torch.stack(rows, dim=1)
    room = free[rows].sum(1).tolist()
    picked, taken = [], set()
    for i, walk in enumerate(rows.tolist()):
        if 0 < room[i] < g and taken.isdisjoint(walk):
            picked.append(i)
            taken.update(walk)
            if len(picked) == FULL_RUNS:
                break
    runs = cand[torch.tensor(picked, dtype=torch.int64, device=device)]
    keys = runs.repeat_interleave(g, dim=0)
    vals = torch.arange(nfill, nfill + keys.shape[0], dtype=torch.int32,
                        device=device)
    ks = twin(ops.append, table_planes(ktab)[0])(*table_planes(ktab), keys,
                                                 vals, **kw)
    ps = ops.append_plain(*table_planes(ptab), keys, vals, **kw)
    checks = {f"full_{part}": ok for part, ok in check_append(
        table_planes(ktab), table_planes(ptab), keys, ks, ps, **kw).items()}
    checks["full_exact_status"] = torch.equal(ks, ps)
    checks["full_exact_planes"] = all(
        torch.equal(ktab.store[k], ptab.store[k]) for k in ktab.store)
    landed = (ps == STATUS_INSERTED).view(-1, g).sum(1)
    checks["full_partway_runs"] = len(picked) > 0 and bool(
        ((landed > 0) & (landed < g)).all())
    return checks


def run_bucket_case(n: int, *, r: int, growth: float, s0: int, device,
                    window: int = 32) -> dict[str, bool]:
    """Hold ``cops_bucket_walk`` (on the CPU, whatever the wrapper runs)
    bit-exact against ``bucket_walk_plain`` on a bucket list built through
    ``bucket_list.insert``, sized as Fig. 7's wc-bl cells (key capacity
    keys / ``LOAD``, pool 2n + 64 slots, schedule (``growth``, ``s0``)).

    Batch 1 holds ``n / r`` distinct keys (``distinct_keys``), each
    repeated ``r`` times in a row, values ``0 .. n-1``; batch 2 adds n/8
    pairs, half to present keys (their chains grow across batches), half
    to new keys.  After each batch the walk runs for every present key, a
    quarter of them twice (duplicate queries walk once) and absent keys;
    the arenas must be identical and stamp each present key's values.
    """
    from repro_torch.core import bucket_list
    nk = max(16, n // r)
    pool = distinct_keys(0, nk + nk // 8 + nk // 8, device)
    base, absent, new = pool[:nk], pool[nk:nk + nk // 8], pool[nk + nk // 8:]
    table = bucket_list.create(int(nk / LOAD), 2 * n + 64, s0=s0,
                               growth=growth, window=window, device=device)
    schedule = bucket_list._schedule(table)
    checks = {}

    def batch(tag, keys, start):
        nonlocal table
        vals = torch.arange(start, start + keys.shape[0], dtype=torch.int32,
                            device=device)
        table, status = bucket_list.insert(table, keys, vals)
        checks[f"{tag}_inserted"] = bool((status == STATUS_INSERTED).all())
        present = torch.unique(keys)
        queries = torch.cat([present, present[: present.shape[0] // 4],
                             absent])
        found, *handles = bucket_list._handle_probe(table, queries)[2:6]
        args = (table.pool, *handles, found, *schedule)
        got = ops.bucket_walk(*args)
        checks[f"{tag}_walk_exact"] = _same(got, ops.bucket_walk_plain(*args))
        checks[f"{tag}_stamps"] = (int((got[0] < queries.shape[0]).sum())
                                   == int(handles[1][found].sum()))

    batch("batch1", base.repeat_interleave(r), 0)
    half = n // 16
    batch2 = torch.cat([base[:half // r + 1].repeat_interleave(r)[:half],
                        new.repeat_interleave(r)[:n // 8 - half]])
    batch("batch2", batch2, n)
    return checks


def chain_values(qa, ra, pool, n: int) -> list[list[int]]:
    """Each query's values from a chain walk's arenas, in rank order: the
    pool words of the slots stamped with the query, sorted by their rank
    (what ``retrieve_all`` emits); [] for a query no slot names."""
    slots = torch.nonzero(qa < n).squeeze(1)
    order = torch.argsort(qa[slots].long() * (1 << 31) + ra[slots].long())
    slots = slots[order]
    got = [[] for _ in range(n)]
    for q, v in zip(qa[slots].tolist(), pool[slots].tolist()):
        got[q].append(v)
    return got


def run_chain_case(*, growth: float, s0: int, device, window: int = 32,
                   warp_keys: int = 8, seed: int = 5,
                   reference=None) -> dict[str, bool]:
    """Hold ``cops_bucket_walk`` (on the CPU, whatever the wrapper runs)
    bit-exact against ``bucket_walk_plain`` where chains are long and
    scattered, as in Fig. 8's index.

    A bucket list (key capacity 2^11 at ``LOAD``, schedule (``growth``,
    ``s0``)) is built by ``CHAIN_ROUNDS`` insert batches, as Fig. 8 indexes
    one genome a batch: 16 long keys take ``CHAIN_LONG`` values spread
    over every batch, 512 keys 1 to 3 values in a random third of the
    batches, and each batch 32 keys of its own; each batch is shuffled
    (``seed``).  So a long key's chain holds a bucket from many batches,
    each allocated where its batch's run of the pool lies.  The queries:
    the long keys first, then the others, a quarter of them again, and
    absent keys; they are walked whole ("all") and as their first 1,
    ``warp_keys`` - 1, ``warp_keys``, ``warp_keys`` + 1 and 33 queries,
    each with the handle probe's ``found`` ("found") and with whole groups
    of ``warp_keys`` and of 32 queries made inactive besides ("warps").

    Returns ``{check: holds}``: each walk bit-exact (``exact_{batch}_
    {mask}``) and its arenas giving each active query exactly its key's
    values in insertion order and no other query a slot
    (``values_{batch}_{mask}``); with ``reference`` (a function of the
    table, the active flags and the ``ptr``, ``cnt`` and ``bidx`` handle
    fields that returns the two arenas), the whole batch's arenas equal to
    its (``reference_{mask}``); and that the case reaches what it is
    for: a chain of at least 6 buckets (``reaches_long_chains``), links
    to a bucket that does not end right before the linking one
    (``reaches_scattered_buckets``), a bucket of more than 32 values at
    growth 2 (``reaches_large_buckets``), and a warp whose queries are all
    inactive (``reaches_inactive_warps``).
    """
    from repro_torch.core import bucket_list
    gen = torch.Generator().manual_seed(seed)
    long_keys, mid_keys = 16, 512
    own = 32
    ids = distinct_keys(0, long_keys + mid_keys + CHAIN_ROUNDS * own + 64,
                        "cpu")
    longs, mids = ids[:long_keys], ids[long_keys:long_keys + mid_keys]
    owns = ids[long_keys + mid_keys:-64].view(CHAIN_ROUNDS, own)
    absent = ids[-64:]
    per = [CHAIN_LONG // CHAIN_ROUNDS + (b < CHAIN_LONG % CHAIN_ROUNDS)
           for b in range(CHAIN_ROUNDS)]
    mid_in = torch.rand((CHAIN_ROUNDS, mid_keys), generator=gen) < 1 / 3
    mid_r = torch.randint(1, 4, (CHAIN_ROUNDS, mid_keys), generator=gen)
    own_r = torch.randint(1, 5, (CHAIN_ROUNDS, own), generator=gen)
    batches, total = [], 0
    for b in range(CHAIN_ROUNDS):
        keys = torch.cat([longs.repeat_interleave(per[b]),
                          mids[mid_in[b]].repeat_interleave(
                              mid_r[b][mid_in[b]]),
                          owns[b].repeat_interleave(own_r[b])])
        keys = keys[torch.randperm(keys.shape[0], generator=gen)]
        batches.append(keys)
        total += keys.shape[0]
    table = bucket_list.create(int((1 << 11) * LOAD), 4 * total + 64, s0=s0,
                               growth=growth, window=window, device=device)
    inserted = {}
    checks = {"inserted": True}
    start = 0
    for keys in batches:
        keys = keys.to(device)
        vals = torch.arange(start, start + keys.shape[0], dtype=torch.int32,
                            device=device)
        table, status = bucket_list.insert(table, keys, vals)
        checks["inserted"] &= bool((status == STATUS_INSERTED).all())
        for k, v in zip(as_u32(keys).tolist(), vals.tolist()):
            inserted.setdefault(k, []).append(v)
        start += keys.shape[0]
    others = torch.cat([mids, owns.reshape(-1)])
    others = others[torch.randperm(others.shape[0], generator=gen)]
    queries = torch.cat([longs, others, others[: others.shape[0] // 4],
                         absent]).to(device)
    schedule = bucket_list._schedule(table)
    found, ptr, rcnt, bidx = bucket_list._handle_probe(table, queries)[2:6]
    i = torch.arange(queries.shape[0], device=device)
    masks = {"found": found,
             "warps": found & ((i // warp_keys) % 5 != 3)
             & ((i // 32) % 7 != 5)}
    sizes = (None, 1, warp_keys - 1, warp_keys, warp_keys + 1, 33)
    for size in sizes:
        label = "all" if size is None else str(size)
        m = queries.shape[0] if size is None else size
        for name, active in masks.items():
            args = (table.pool, ptr[:m], rcnt[:m], bidx[:m], active[:m],
                    *schedule)
            got = ops.bucket_walk(*args)
            checks[f"exact_{label}_{name}"] = _same(
                got, ops.bucket_walk_plain(*args))
            want = [inserted[k] if a else [] for k, a in
                    zip(as_u32(queries[:m]).tolist(), active[:m].tolist())]
            checks[f"values_{label}_{name}"] = (
                chain_values(*got, as_u32(table.pool), m) == want)
            if reference is not None and size is None:
                checks[f"reference_{name}"] = _same(
                    got, reference(table, active, ptr, rcnt, bidx))
    sizes_t, cum_t = (x.long() for x in schedule)
    q = torch.nonzero(found).squeeze(1)
    j, p = bidx[q].long(), as_u32(ptr[q])
    scattered = large = 0
    while q.numel():
        link = j > 0
        prev = as_u32(table.pool[p[link]])
        pj = j[link] - 1
        scattered += int((prev + (pj > 0) + sizes_t[pj] != p[link]).sum())
        large += int((sizes_t[j] > 32).sum())
        q, j, p = q[link], pj, prev
    checks["reaches_long_chains"] = int(bidx[found].max()) >= 5
    checks["reaches_scattered_buckets"] = scattered > 0
    checks["reaches_large_buckets"] = growth < 2 or large > 0
    dead = ~masks["warps"].view(-1)[: queries.shape[0] // warp_keys
                                    * warp_keys].view(-1, warp_keys)
    checks["reaches_inactive_warps"] = bool(dead.all(1).any())
    return checks
