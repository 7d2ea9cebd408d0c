"""Table migration and the growth policy: the live-set sweep, growth,
tombstone compaction and ``insert_or_grow``.

The port of ``repro.core.migrate`` for the open-addressing tables
(single-value, counting, hash set, multi-value) on the SOA store:

- ``live_entries`` sweeps every live slot out of the store (tombstones
  dropped), and ``grow`` / ``compact`` re-insert the sweep into a fresh
  store through the bulk insert, so the live key/value set (for a
  multi-value table, each key's values) is preserved exactly; on the CPU
  the fresh store's planes are bit-identical to the JAX package's.  The
  sweep also feeds ``bloom.rebuild_from_table`` and the elastic service's
  ``reshard``.  ``compact_in_graph`` is ``compact`` without the registry
  counters, for single-value and counting tables.
- ``GrowthPolicy`` says when to migrate (load-factor and tombstone-density
  thresholds, growth factor, capacity cap), ``occupancy`` reads the
  store's census, ``maybe_migrate`` applies the policy ahead of a batch,
  and ``insert_or_grow`` inserts under it: it migrates before the batch
  when the policy says so, then retries any ``STATUS_FULL`` residue after
  a compaction or an emergency grow, the failed subset under its own mask.

Every decision reads the census on the host: growth changes the store's
shape, which is the caller's business between batches.  The reference
skips the policy under ``jit`` tracing (``_note_traced_skip`` and the
tracer branch of ``_host_int``); the port is never traced, so those have
no counterpart.

Counters (``obs.registry.REGISTRY``): ``table.grows``,
``table.compactions``, ``table.migrated_slots``.

Not ported: the bucket list's stream, migration and pool growth
(``_bucket_stream``, ``_migrate_bucket``, ``POOL_FULL`` retries; ROADMAP.md
queue 1 item 5b) and the quotient decode (item 4, whose tables the port
does not create).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import multi_value as mv
from repro_torch.core import single_value as sv
from repro_torch.core.common import (
    EMPTY_WORD,
    STATUS_FULL,
    STATUS_POOL_FULL,
    TOMBSTONE_WORD,
)
from repro_torch.obs.registry import REGISTRY

# ---------------------------------------------------------------------------
# policy
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GrowthPolicy:
    """When to migrate, and by how much (frozen, hashable).

    - ``max_load_factor``: grow when (live + incoming) / capacity would
      exceed this.  COPS walks degenerate near full, so the default leaves
      headroom well before the hard ceiling.
    - ``max_tombstone_density``: compact when tombstones / capacity exceeds
      this.  Tombstones do not stop probe walks, so density is pure
      probe-length tax; compaction reclaims the slots without a larger
      store.
    - ``growth_factor``: capacity multiplier per grow (geometric growth
      keeps the migration work amortized O(1) per insert).
    - ``max_capacity``: hard cap; at the cap the policy compacts if it can
      and otherwise lets ``STATUS_FULL`` surface to the caller.
    """
    max_load_factor: float = 0.85
    max_tombstone_density: float = 0.25
    growth_factor: float = 2.0
    max_capacity: int = 1 << 24


DEFAULT_POLICY = GrowthPolicy()


def _refuse_bucket_list(table) -> None:
    from repro_torch.core import bucket_list as bl
    if isinstance(table, bl.BucketListHashTable):
        raise NotImplementedError(
            "migrating a bucket list is not ported to repro_torch yet: see "
            "ROADMAP.md queue 1 item 5b (the rest of the bucket list)")


def _sweep_oa(table):
    """Live-slot sweep of an open-addressing SOA store: ``(keys (c, kw),
    values (c, vw), live (c,))`` over the slot arena in slot order, int32
    words, zero where not live (the batch is sentinel-free)."""
    kp = table.store["keys"].reshape(table.key_words, -1).T
    vp = table.store["values"].reshape(table.value_words, -1).T
    live = (kp[:, 0] != EMPTY_WORD) & (kp[:, 0] != TOMBSTONE_WORD)
    return (torch.where(live[:, None], kp, 0),
            torch.where(live[:, None], vp, 0), live)


def live_entries(table):
    """Public live-set sweep: ``(keys (c, kw), values (c, vw), live (c,))``
    of a single- or multi-value table (see ``_sweep_oa``)."""
    _refuse_bucket_list(table)
    return _sweep_oa(table)


def _replace_max_probes(table):
    """max_probes for the migrated table: a full-table default follows the
    new geometry; an explicit tighter bound is preserved."""
    return None if table.max_probes >= table.num_rows else table.max_probes


def _fresh_like(table, new_capacity):
    create = (mv.create if isinstance(table, mv.MultiValueHashTable)
              else sv.create)
    return create(new_capacity, key_words=table.key_words,
                  value_words=table.value_words, window=table.window,
                  scheme=table.scheme, layout=table.layout, seed=table.seed,
                  max_probes=_replace_max_probes(table), device=table.device)


def _migrate(table, new_capacity):
    """Sweep + bulk insert into a fresh store of >= ``new_capacity``;
    returns ``(fresh, migrated live slots)``.  Raises when the fresh table
    holds fewer entries than the old one (target too small)."""
    _refuse_bucket_list(table)
    keys, vals, live = _sweep_oa(table)
    fresh = _fresh_like(table, new_capacity)
    insert = (mv.insert if isinstance(table, mv.MultiValueHashTable)
              else sv.insert)
    fresh, _ = insert(fresh, keys, vals, mask=live)
    if fresh.count != table.count:
        raise ValueError(
            f"grow/compact: migrated {fresh.count} of {table.count} live "
            "entries — target capacity too small for the live set (grow "
            "further or raise max_probes)")
    return fresh, int(live.sum())


def grow(table, new_capacity: int):
    """Migrate every live entry into a fresh store of >= ``new_capacity``.

    Tombstones are dropped in transit; the live set is preserved exactly.
    Works at any target >= the live set: growth and shrink are the same
    sweep.
    """
    fresh, migrated = _migrate(table, new_capacity)
    REGISTRY.counter("table.grows").inc(1)
    REGISTRY.counter("table.migrated_slots").inc(migrated)
    return fresh


def compact(table):
    """Rebuild the table at its current capacity, dropping tombstones
    (the row count is already prime, so the geometry is unchanged)."""
    _refuse_bucket_list(table)
    fresh, migrated = _migrate(table, table.capacity)
    REGISTRY.counter("table.compactions").inc(1)
    REGISTRY.counter("table.migrated_slots").inc(migrated)
    return fresh


def compact_in_graph(table):
    """Same-geometry tombstone compaction of a single-value or counting
    table: ``compact`` without the registry counters (the reference's form
    for its in-graph streaming loop, whose own counters count it).
    Multi-value and bucket-list tables raise ``TypeError``, as in the
    reference."""
    from repro_torch.core import bucket_list as bl
    if isinstance(table, (bl.BucketListHashTable, mv.MultiValueHashTable)):
        raise TypeError("compact_in_graph supports single-value/counting "
                        "tables only; use host-side compact() for "
                        "multi-value and bucket-list tables")
    return _migrate(table, table.capacity)[0]


# ---------------------------------------------------------------------------
# occupancy + policy decisions (host-side)
# ---------------------------------------------------------------------------

def occupancy(table):
    """Host-side occupancy census: ``(live, tombstones, capacity)`` ints,
    from key plane 0 of the store (``obs.metrics.slot_stats``)."""
    _refuse_bucket_list(table)
    from repro_torch.obs import metrics
    live, tomb, _ = metrics.slot_stats(table.ops, table.store)
    return int(live), int(tomb), table.capacity


def _grown_capacity(cap: int, need: int, policy: GrowthPolicy) -> int:
    """Smallest geometric step of ``cap`` that fits ``need`` under the
    policy's load-factor threshold, clamped to ``max_capacity``."""
    new_cap = cap
    while (new_cap < policy.max_capacity
           and need > policy.max_load_factor * new_cap):
        new_cap = min(int(math.ceil(new_cap * policy.growth_factor)),
                      policy.max_capacity)
    return new_cap


def maybe_migrate(table, policy: GrowthPolicy, incoming: int = 0):
    """Apply the policy ahead of an ``incoming``-element batch.

    Grows when the batch could push live occupancy past the load-factor
    threshold (at the capacity cap: compacts instead if tombstones are the
    blocker); compacts when tombstone density alone crosses its threshold.
    Returns the (possibly migrated) table.
    """
    live, tomb, cap = occupancy(table)
    need = live + incoming
    if need > policy.max_load_factor * cap:
        new_cap = _grown_capacity(cap, need, policy)
        if new_cap > cap:
            return grow(table, new_cap)
        if tomb > 0:                      # at the cap: reclaim what we can
            return compact(table)
        return table
    if (tomb > policy.max_tombstone_density * cap
            or need + tomb > policy.max_load_factor * cap):
        return compact(table)
    return table


# ---------------------------------------------------------------------------
# insert_or_grow — the consumer-facing wrapper
# ---------------------------------------------------------------------------

def _default_insert(table, keys, values, mask):
    if isinstance(table, mv.MultiValueHashTable):
        return mv.insert(table, keys, values, mask)
    return sv.insert(table, keys, values, mask)


def insert_or_grow(table, keys, values=None, mask=None, *,
                   policy: GrowthPolicy = DEFAULT_POLICY,
                   insert_fn=None, max_attempts: int = 4):
    """Insert with the auto-growth policy: never hard-fail while capacity
    headroom remains.  Returns ``(table, status)`` like ``insert``.

    1. ``maybe_migrate`` pre-checks the policy (grow for load, compact for
       tombstone churn), so the common case inserts into a table with
       headroom and no element reports FULL;
    2. the batch inserts through ``insert_fn(table, keys, values, mask)``
       (default: the table kind's own ``insert``; ``counting.insert_or_grow``
       passes an adapter for its read-modify-write);
    3. any ``STATUS_FULL`` residue triggers a compaction (when tombstones
       were the blocker) or an emergency grow, and the *failed subset*
       retries under its own mask, statuses merged: at most
       ``max_attempts`` rounds, geometric capacity each round.

    At ``policy.max_capacity`` with nothing left to compact, FULL statuses
    surface to the caller unchanged.  The batch is normalized once, on the
    table's device; every migration leaves the device where it was.
    """
    _refuse_bucket_list(table)
    if insert_fn is None:
        insert_fn = _default_insert
    keys = sv.normalize_key_batch(keys, table.key_words, table.device)
    n = keys.shape[0]
    if values is not None:
        values = sv.normalize_words(values, table.value_words, "values",
                                    table.device)
    mask = sv.normalize_mask(mask, n, table.device)
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=table.device)
    table = maybe_migrate(table, policy, incoming=n)
    table, status = insert_fn(table, keys, values, mask)

    for _ in range(max_attempts):
        failed = (status == STATUS_FULL) | (status == STATUS_POOL_FULL)
        n_failed = int(failed.sum())
        if n_failed == 0:
            break
        live, tomb, cap = occupancy(table)
        if tomb and live + n_failed <= policy.max_load_factor * cap:
            table = compact(table)         # tombstones were the blocker
        else:
            new_cap = _grown_capacity(cap, live + n_failed, policy)
            if new_cap <= cap:
                # occupancy says "fits" yet FULL happened: probe-sequence
                # exhaustion — take one geometric step for fresh geometry
                new_cap = min(int(math.ceil(cap * policy.growth_factor)),
                              policy.max_capacity)
            if new_cap <= cap:
                break                      # at max_capacity: surface FULL
            table = grow(table, new_cap)
        retry_mask = mask & failed
        table, status2 = insert_fn(table, keys, values, retry_mask)
        status = torch.where(retry_mask, status2, status)
    return table, status
