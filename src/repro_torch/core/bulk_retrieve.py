"""Bulk retrieval, membership and erase — ``repro.core.bulk_retrieve``.

Every walk matches on every key plane: a table of two-word keys (u64 or
two-column composite keys) walks through the two-plane twin of each
kernel wrapper (``lookup64``, ``retrieve_walk64``), and its dedup front
end sorts one int64 word per key (``bulk._group_fast``).

**Single-value.**  Every entry point is one walk per query through
``kernels.cops.ops.lookup``: the ``cops_lookup`` kernel on a CUDA table,
its plain version (``bulk.probe_matches`` + a gather) on a CPU table.
The kernel reads the value of a table with one value word; a table with
two (the group-by's accumulator and count) or none (a hash set) walks
with no value plane, and its values are gathered at the slots found.
The walk is read-only, so ``retrieve_single`` and ``contains_single``
walk every query as it comes — the output is bit-exact against the JAX
engine, which walks one representative per distinct key and fans the
result out.  ``erase_single`` keeps that dedup front end (``group_queries``
/ ``_locate_reps``): the live count drops by the number of DISTINCT keys
erased, and the walk's flat slot output drives one batched tombstone
write, in place.

**Multi-value** (the paper's counting pass and (values, offsets, counts)
layout, §IV-B.4), in three layers:

1. **Dedup front end** (``group_queries``): one representative walks per
   distinct live query key.
2. **Fused walk** (``fused_walk`` -> ``kernels.cops.ops.retrieve_walk``:
   the ``cops_retrieve`` kernel on a CUDA table, its plain version on a
   CPU table).  Each representative walks to the first window holding an
   EMPTY, counting its matches; with ``collect`` every matching slot is
   stamped in a slot arena with (query batch index, rank in walk order).
   Distinct representatives never match the same slot.
3. **Compaction** (``_emit`` / ``_emit_dense``): the counts give the
   prefix-sum offsets, the arena's matched slots are ordered
   representative-dense, and one gather fans the slot values out into
   every query's segment — duplicates replicate their representative's.

``erase_multi`` runs the collecting walk and tombstones every stamped
slot in one batched write, in place.  Every output is bit-exact against
the JAX engine (``backend="jax"`` and ``"pallas"``).  Unlike the JAX
engine, the compaction reads only the arena's matched slots (a
``nonzero``), not an ``arange`` over the whole arena; its temporaries are
int64 and scale with the matches and ``out_capacity``.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import bulk


def _lookup(table, keys, slots=False):
    """The lookup walk of every key; reads the value plane of a table with
    one (else the values come back None: read them at the slots)."""
    _, scheme, seed, max_probes = bulk._tstatic(table)
    lookup, table_keys = bulk._cops(table, "lookup")
    plane = table.store["values"][0] if table.value_words == 1 else None
    return lookup(table_keys, plane, keys, seed=seed, scheme=scheme,
                  max_probes=max_probes, slots=slots)


def group_queries(keys, live):
    """Group duplicate query keys ((n,) or (n, 2) planes); returns
    ``(is_rep, rep_of)`` in batch order (``rep_of`` is ``n`` for elements
    whose key has no live occurrence).  Keys that differ in any plane,
    the high one included, never share a group."""
    is_rep, rep_of, _, _ = bulk._group_fast(keys, live, last=False)
    return is_rep, rep_of


def _live(n, mask, device):
    """The batch's live mask: ``mask``, or every element."""
    return (torch.ones((n,), dtype=torch.bool, device=device)
            if mask is None else mask)


def _locate_reps(table, keys, live):
    """One walk per distinct live key: ``(rep_of, rep_idx, found, slot)``,
    with ``found`` / ``slot`` aligned to ``rep_idx``."""
    is_rep, rep_of = group_queries(keys, live)
    rep_idx = torch.nonzero(is_rep).squeeze(1)
    _, found, slot = _lookup(table, keys[rep_idx], slots=True)
    return rep_of, rep_idx, found, slot


def retrieve_single(table, keys):
    """``(values, found)``: int32 value words (0 where absent) and bools;
    values (n,) for one value word, else (n, value_words), read at each
    found key's slot."""
    if table.value_words == 1:
        values, found, _ = _lookup(table, keys)
        return values, found
    _, found, slot = _lookup(table, keys, slots=True)
    values = table.ops.arena_values(table.store, slot.clamp(min=0))
    return torch.where(found[:, None], values, 0), found


def contains_single(table, keys):
    return _lookup(table, keys)[1]


def erase_single(table, keys, mask=None):
    """Tombstone the slot of every distinct live key found; returns
    ``(table, erased)`` with the live count reduced by the keys erased."""
    n = keys.shape[0]
    if n == 0:
        return table, torch.zeros((0,), dtype=torch.bool, device=keys.device)
    live = _live(n, mask, keys.device)
    rep_of, rep_idx, found, slot = _locate_reps(table, keys, live)
    table.ops.tombstone_slots(table.store, slot[found])
    matched = torch.zeros((n,), dtype=torch.bool, device=keys.device)
    matched[rep_idx] = found
    erased = live & matched[rep_of.clamp(max=n - 1)] & (rep_of < n)
    count = table.count - int(found.sum())
    return dataclasses.replace(table, count=count), erased


# ---------------------------------------------------------------------------
# multi-value: fused walk, compaction and entry points
# ---------------------------------------------------------------------------

def fused_walk(table, keys, active, *, collect):
    """``(counts, qarena, rank_arena)`` of the walk of the ``active``
    (distinct) keys; the arenas are None unless ``collect``.  The arena
    holds one (query, rank) pair per slot, so a walk must never revisit a
    row: every cops / linear walk is clamped to the rows its scheme reaches
    (``probing.effective_probes``)."""
    _, scheme, seed, max_probes = bulk._tstatic(table)
    walk, table_keys = bulk._cops(table, "retrieve_walk")
    return walk(table_keys, keys, active, seed=seed, scheme=scheme,
                max_probes=max_probes, collect=collect)


def _fan_out(rcnt, rep_of, live, n):
    """Per-query counts from representative counts (masked queries -> 0)."""
    return torch.where(live, rcnt[rep_of.clamp(0, max(n - 1, 0))], 0)


def rep_offsets(is_rep, rcnt):
    """Representative-dense base offsets (int64): where each
    representative's segment starts in the dense slot list."""
    repc = torch.where(is_rep, rcnt.to(torch.int64), 0)
    return torch.cumsum(repc, 0) - repc


def dense_capacity(cap, out_capacity) -> int:
    """Size of the representative-dense slot list: ``min(cap,
    out_capacity)`` holds every position a valid output element reads."""
    return min(cap, max(int(out_capacity), 1))


def _emit(arena_values, cap, out_capacity, counts, is_rep, rep_of, rcnt,
          qarena, rank_arena):
    """Pack the walk's arena into the prefix-sum output layout.

    One scatter orders the matched slots representative-dense (walk order
    within each representative); ``_emit_dense`` gathers their values into
    every query's segment.  Positions past ``dense_capacity`` are dropped,
    as the reference's ``mode="drop"`` scatter drops them.
    """
    n = rep_of.shape[0]
    rep_base = rep_offsets(is_rep, rcnt)
    dcap = dense_capacity(cap, out_capacity)
    slots = torch.nonzero(qarena < n).squeeze(1)               # int64
    pos = rep_base[qarena[slots].to(torch.int64)] + rank_arena[slots]
    keep = pos < dcap
    rep_dense = torch.zeros((dcap,), dtype=torch.int64, device=slots.device)
    rep_dense[pos[keep]] = slots[keep]
    return _emit_dense(arena_values, out_capacity, counts, rep_of, rep_base,
                       rep_dense)


def _emit_dense(arena_values, out_capacity, counts, rep_of, rep_base,
                rep_dense):
    """Gather half of ``_emit``: ``(values (out_capacity, vw), offsets
    (n + 1,) int32, counts)``.  Entries past the true total stay zero."""
    n = rep_of.shape[0]
    dev = counts.device
    offsets = torch.zeros((n + 1,), dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(counts, 0)
    m = min(int(out_capacity), int(offsets[n]))                # valid entries
    j = torch.arange(m, dtype=torch.int64, device=dev)
    seg = torch.searchsorted(offsets[1:], j, right=True)
    gpos = rep_base[rep_of[seg]] + (j - offsets[seg])
    svals = arena_values(rep_dense[gpos])                      # (m, vw)
    out = torch.zeros((int(out_capacity), svals.shape[1]), dtype=svals.dtype,
                      device=dev)
    out[:m] = svals
    return out, offsets.to(torch.int32), counts


def _emit_store(table, out_capacity, counts, is_rep, rep_of, rcnt, qarena,
                rank_arena):
    """``_emit`` over an open-addressing table's own slot arena."""
    return _emit(lambda s: table.ops.arena_values(table.store, s),
                 table.ops.arena_capacity, out_capacity, counts, is_rep,
                 rep_of, rcnt, qarena, rank_arena)


def count_multi(table, keys, mask=None):
    """The counting pass: per-query int32 match counts (0 where masked)."""
    n = keys.shape[0]
    if n == 0:
        return torch.zeros((0,), dtype=torch.int32, device=keys.device)
    live = _live(n, mask, keys.device)
    is_rep, rep_of = group_queries(keys, live)
    rcnt, _, _ = fused_walk(table, keys, is_rep, collect=False)
    return _fan_out(rcnt, rep_of, live, n)


def retrieve_all_multi(table, keys, out_capacity, mask=None):
    """One fused walk, then the compaction -> ``(values (out_capacity,)
    int32, offsets (n + 1,) int32, counts (n,) int32)``."""
    n = keys.shape[0]
    dev = keys.device
    if n == 0:
        return (torch.zeros((int(out_capacity),), dtype=torch.int32,
                            device=dev),
                torch.zeros((1,), dtype=torch.int32, device=dev),
                torch.zeros((0,), dtype=torch.int32, device=dev))
    live = _live(n, mask, dev)
    is_rep, rep_of = group_queries(keys, live)
    rcnt, qarena, rank_arena = fused_walk(table, keys, is_rep, collect=True)
    counts = _fan_out(rcnt, rep_of, live, n)
    out, offsets, counts = _emit_store(table, out_capacity, counts, is_rep,
                                       rep_of, rcnt, qarena, rank_arena)
    return out[:, 0], offsets, counts


def erase_multi(table, keys):
    """Tombstone every pair whose key matches, in place; returns ``(table,
    erased_counts (n,) int32)`` with the live count reduced."""
    n = keys.shape[0]
    if n == 0:
        return table, torch.zeros((0,), dtype=torch.int32, device=keys.device)
    live = _live(n, None, keys.device)
    is_rep, rep_of = group_queries(keys, live)
    rcnt, qarena, _ = fused_walk(table, keys, is_rep, collect=True)
    table.ops.tombstone_slots(table.store,
                              torch.nonzero(qarena < n).squeeze(1))
    erased = int(rcnt[is_rep].sum())
    return (dataclasses.replace(table, count=table.count - erased),
            _fan_out(rcnt, rep_of, live, n))
