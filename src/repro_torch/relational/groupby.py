"""Group-by aggregation (sum / min / max / count / mean), ``repro.relational.groupby``.

Every group key owns one slot of a ``SingleValueHashTable`` with two value
words: plane 0 the aggregate's accumulator, plane 1 the group's
cardinality.  ``update`` folds a batch in through
``single_value.update_values``: the bulk engine picks one representative
per distinct key in torch, and the ``cops_update`` kernel on the card
(``cops_update64`` for two-word keys) first combines every other row's
operand into its group's representative, then walks the representatives,
each folding the combined operand into its group's slot or claiming a
slot for a new group.  ``mean`` finalizes as float32 accumulator / count;
``sum`` wraps mod 2^32, like the u32 arithmetic it is built on.

Group keys may be composite: a tuple of u32 columns, an (n, key_words)
plane batch or u64 keys; ``aggregate`` infers ``key_words``.  ``finalize``
returns two-word group keys as (capacity, 2) planes
(``relational.util.unpack_columns`` gives the columns back).  Tables
live on the CUDA card unless ``device="cpu"``; every result is a tensor on
the table's device.
"""

from __future__ import annotations

import torch

from repro_torch.core import single_value as sv
from repro_torch.core.common import (
    DEFAULT_SEED,
    DEFAULT_WINDOW,
    EMPTY_WORD,
    TOMBSTONE_WORD,
    as_u32,
)
from repro_torch.relational.util import capacity_for  # noqa: F401 (public API)

AGGS = ("sum", "min", "max", "count", "mean")

GroupByTable = sv.SingleValueHashTable


def create(min_capacity: int, *, key_words: int = 1,
           window: int = DEFAULT_WINDOW, scheme: str = "cops",
           layout: str = "soa", seed: int = DEFAULT_SEED,
           max_probes: int | None = None, device=None) -> GroupByTable:
    """An empty group-by table: value plane 0 = accumulator, plane 1 = count."""
    return sv.create(min_capacity, key_words=key_words, value_words=2,
                     window=window, scheme=scheme, layout=layout, seed=seed,
                     max_probes=max_probes, device=device)


def _fold_spec(agg: str) -> tuple[str, str]:
    """The per-word fold of (accumulator, count) with (operand, weight),
    which is also its own pre-aggregation (``update_values``' combiner)."""
    if agg in ("sum", "mean", "count"):
        return ("add", "add")
    if agg == "min":
        return ("min", "add")
    if agg == "max":
        return ("max", "add")
    raise ValueError(f"agg={agg!r} not in {AGGS}")


def update(table: GroupByTable, agg: str, keys, values=None, mask=None,
           ) -> tuple[GroupByTable, torch.Tensor]:
    """Fold a batch of (key, value) elements into the running aggregate,
    in place.  ``values`` may be omitted for ``count``.  Returns (table,
    status (n,) int32) with the usual STATUS_* codes per element."""
    spec = _fold_spec(agg)
    keys = sv.normalize_key_batch(keys, table.key_words, table.device)
    n = keys.shape[0]
    if values is None:
        if agg != "count":
            raise ValueError(f"agg={agg!r} needs a values operand")
        values = torch.zeros((n,), dtype=torch.int32, device=table.device)
    v = sv.normalize_words(values, 1, "values", table.device)
    ones = torch.ones((n,), dtype=torch.int32, device=table.device)
    payload = torch.stack([ones if agg == "count" else v, ones], dim=1)
    return sv.update_values(table, keys, spec, payload, mask=mask,
                            combine=spec)


def _finalize_planes(agg: str, acc, cnt, live):
    if agg == "mean":
        out = (as_u32(acc).to(torch.float32)
               / as_u32(cnt).clamp(min=1).to(torch.float32))
        return torch.where(live, out, 0.0)
    out = cnt if agg == "count" else acc
    return torch.where(live, out, 0)


def lookup(table: GroupByTable, agg: str, keys,
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-key aggregate -> (values, found): int32 u32 bits, float32 for
    ``mean``; 0 where absent."""
    _fold_spec(agg)
    vals, found = sv.retrieve(table, keys)
    return _finalize_planes(agg, vals[:, 0], vals[:, 1], found), found


def finalize(table: GroupByTable, agg: str,
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dump every live group -> (keys, aggregates, live_mask) over the
    table's full capacity; ``live_mask`` marks the ``table.count`` real
    groups.  Keys come back (capacity,) for 1-word keys, else (capacity,
    key_words) planes; 0 where not live."""
    _fold_spec(agg)
    kp = table.store["keys"].reshape(table.key_words, -1)       # (kw, c)
    vp = table.store["values"].reshape(2, -1)                   # (2, c)
    live = (kp[0] != EMPTY_WORD) & (kp[0] != TOMBSTONE_WORD)
    out = _finalize_planes(agg, vp[0], vp[1], live)
    if table.key_words == 1:
        keys = torch.where(live, kp[0], 0)
    else:
        keys = torch.where(live[:, None], kp.T, 0)
    return keys, out, live


def aggregate(keys, values, min_capacity: int, agg: str, *,
              key_words: int | None = None, window: int = DEFAULT_WINDOW,
              mask=None, device=None,
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         GroupByTable]:
    """One-shot group-by: returns (group_keys, aggregates, live, table).
    ``keys`` may be a tuple of u32 columns, an (n, key_words) plane batch,
    u64 keys or a flat (n,) batch; ``key_words`` is inferred when
    omitted."""
    device = sv.resolve_device(device)
    keys, key_words = sv.normalize_keys(keys, key_words, device)
    table = create(min_capacity, key_words=key_words, window=window,
                   device=device)
    table, _ = update(table, agg, keys, values, mask=mask)
    gk, out, live = finalize(table, agg)
    return gk, out, live, table
