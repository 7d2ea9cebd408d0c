"""Table migration: the live-set sweep, growth and tombstone compaction.

The port of the migration engine of ``repro.core.migrate`` for the
open-addressing tables (single-value, counting, hash set, multi-value) on
the SOA store: ``live_entries`` sweeps every live slot out of the store
(tombstones dropped), and ``grow`` / ``compact`` re-insert the sweep into
a fresh store through the bulk insert, so the live key/value set (for a
multi-value table, each key's values) is preserved exactly; on the CPU
the fresh store's planes are bit-identical to the JAX package's.  The
sweep also feeds ``bloom.rebuild_from_table`` and the elastic service's
``reshard``.

Counters (``obs.registry.REGISTRY``): ``table.grows``,
``table.compactions``, ``table.migrated_slots``.

Not ported: the bucket list's stream (``_bucket_stream``,
``_migrate_bucket``; ROADMAP.md queue 1 item 5b), the quotient decode
(item 4, whose tables the port does not create), and ``GrowthPolicy``,
``maybe_migrate``, ``insert_or_grow``, ``occupancy`` and
``compact_in_graph`` (item 8).
"""

from __future__ import annotations

import torch

from repro_torch.core import multi_value as mv
from repro_torch.core import single_value as sv
from repro_torch.core.common import EMPTY_WORD, TOMBSTONE_WORD
from repro_torch.obs.registry import REGISTRY


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
