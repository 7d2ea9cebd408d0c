"""MultiValueHashTable — the same key may occur many times (paper §IV-B, V-B).

The port of ``repro.core.multi_value`` on the SOA store, schemes cops and
linear, for 1-word u32 keys and two-word keys (u64 or two-column composite
keys, in every spelling of ``single_value.normalize_key_batch``), with
1-word values.  Every (key, value) pair takes a
slot of its own: ``insert`` appends each pair into the lowest EMPTY or
TOMBSTONE slot of the first window of its walk that has one, without
looking for the key.  ``retrieve_all`` walks to the first window holding
an EMPTY (tombstones do not stop it) and gathers every match on the way.

As in the paper (§IV-B.4), ``retrieve_all`` needs its output size up
front: ``count_values`` is the counting pass, and the caller sizes
``out_capacity`` from it.  Both walk once per distinct query key.

Tables live on one device, chosen at ``create`` as in ``single_value``
(``device=None`` means the CUDA card; ``device="cpu"`` runs the kernels'
plain versions).  ``insert`` and ``erase`` update the store in place and
return a table that shares it, carrying the new ``count``.  Counts and
offsets come back as int32 tensors, values as int32 tensors holding the
u32 bits.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import bulk, bulk_retrieve, layouts
from repro_torch.core.common import DEFAULT_SEED, DEFAULT_WINDOW, table_geometry
from repro_torch.core.single_value import (
    _refuse,
    _with_stats,
    check_ported,
    normalize_key_batch,
    normalize_mask,
    normalize_words,
    resolve_device,
)


@dataclasses.dataclass
class MultiValueHashTable:
    store: dict                 # {"keys": (kw, p, W), "values": (1, p, W)} int32
    count: int                  # live (key, value) pairs
    num_rows: int
    window: int
    key_words: int
    value_words: int
    scheme: str
    layout: str
    seed: int
    max_probes: int

    @property
    def capacity(self) -> int:
        return self.num_rows * self.window

    @property
    def device(self) -> torch.device:
        return self.store["keys"].device

    @property
    def ops(self) -> layouts.SoaOps:
        return layouts.SoaOps(self.num_rows, self.window, self.key_words,
                              self.value_words)

    def load_factor(self) -> float:
        return self.count / self.capacity


def create(min_capacity: int, *, key_words: int = 1, value_words: int = 1,
           window: int = DEFAULT_WINDOW, scheme: str = "cops",
           layout: str = "soa", seed: int = DEFAULT_SEED,
           max_probes: int | None = None, device=None,
           kind: str | None = None, quotient: bool = False,
           ) -> MultiValueHashTable:
    """Create an empty multi-value table (capacity rounds to p*W, p prime)."""
    if quotient:
        raise ValueError("multi-value tables do not support quotient "
                         "storage (single_value-only)")
    if kind is not None:
        if kind != "bucketed":
            raise ValueError(f"unknown table kind {kind!r}")
        _refuse("bucketed", f"kind {kind!r}")
    check_ported(key_words, value_words, scheme, layout)
    device = resolve_device(device)
    num_rows, _ = table_geometry(min_capacity, window)
    ops = layouts.SoaOps(num_rows, window, key_words, value_words)
    return MultiValueHashTable(
        store=ops.create(device), count=0, num_rows=num_rows, window=window,
        key_words=key_words, value_words=value_words, scheme=scheme,
        layout=layout, seed=seed, max_probes=int(max_probes or num_rows))


def insert(table: MultiValueHashTable, keys, values, mask=None,
           stats: bool = False):
    """Append (key, value) pairs; duplicates of a key take distinct slots.
    Returns (table, status (n,) int32: INSERTED / FULL / MASKED), and with
    ``stats=True`` an ``obs.metrics.TableStats``."""
    keys = normalize_key_batch(keys, table.key_words, table.device)
    values = normalize_words(values, table.value_words, "values", table.device)
    if values.shape[0] != keys.shape[0]:
        raise ValueError(f"{values.shape[0]} values for {keys.shape[0]} keys")
    mask = normalize_mask(mask, keys.shape[0], table.device)
    out = bulk.insert_multi(table, keys, values, mask)
    return _with_stats(stats, out, keys, out[1], mask)


def insert_or_grow(table: MultiValueHashTable, keys, values, mask=None, *,
                   policy=None, max_attempts: int = 4):
    """``insert`` under the auto-growth policy: migrates (grow / compact)
    instead of ever returning ``STATUS_FULL`` while capacity headroom
    remains.  Host-side wrapper — see ``core.migrate``."""
    from repro_torch.core import migrate
    return migrate.insert_or_grow(
        table, keys, values, mask,
        policy=migrate.DEFAULT_POLICY if policy is None else policy,
        max_attempts=max_attempts)


def count_values(table: MultiValueHashTable, keys, mask=None,
                 stats: bool = False):
    """Number of stored values per queried key, int32 (0 where masked);
    with ``stats=True`` the tuple ``(counts, TableStats)``."""
    keys = normalize_key_batch(keys, table.key_words, table.device)
    mask = normalize_mask(mask, keys.shape[0], table.device)
    counts = bulk_retrieve.count_multi(table, keys, mask)
    out = _with_stats(stats, (counts,), keys, mask=mask, table=table)
    return out if stats else counts


def retrieve_all(table: MultiValueHashTable, keys, out_capacity: int,
                 mask=None, stats: bool = False):
    """Gather every value of each queried key.

    Returns ``(values (out_capacity,), offsets (n + 1,), counts (n,))``:
    query i's values are ``values[offsets[i]:offsets[i] + counts[i]]``, in
    walk order.  Entries past the true total are zero, and values past
    ``out_capacity`` are dropped: size it with ``count_values``.
    ``stats=True`` appends an ``obs.metrics.TableStats``.
    """
    keys = normalize_key_batch(keys, table.key_words, table.device)
    mask = normalize_mask(mask, keys.shape[0], table.device)
    out = bulk_retrieve.retrieve_all_multi(table, keys, out_capacity, mask)
    return _with_stats(stats, out, keys, mask=mask, table=table)


def erase(table: MultiValueHashTable, keys):
    """Tombstone every pair whose key matches (paper §IV-B.5).  Returns
    (table, erased_counts (n,) int32)."""
    keys = normalize_key_batch(keys, table.key_words, table.device)
    return bulk_retrieve.erase_multi(table, keys)
