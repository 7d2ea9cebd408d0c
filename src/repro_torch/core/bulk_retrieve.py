"""Bulk retrieval, membership and erase — ``repro.core.bulk_retrieve``'s
single-value entry points.

Every entry point is one walk per query through
``kernels.cops.ops.lookup``: the ``cops_lookup`` kernel on a CUDA table,
its plain version (``bulk.probe_matches`` + a gather) on a CPU table.
The walk is read-only, so ``retrieve_single`` and ``contains_single``
walk every query as it comes — the output is bit-exact against the JAX
engine, which walks one representative per distinct key and fans the
result out.  ``erase_single`` keeps that dedup front end (``group_queries``
/ ``_locate_reps``): the live count drops by the number of DISTINCT keys
erased, and the walk's flat slot output drives one batched tombstone
write, in place.

The multi-value walk (``fused_walk``, the arena compaction) is not
ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import bulk


def _lookup(table, keys, slots=False):
    from repro_torch.kernels.cops import ops as cops_ops
    _, scheme, seed, max_probes = bulk._tstatic(table)
    return cops_ops.lookup(table.store["keys"][0], table.store["values"][0],
                           keys, seed=seed, scheme=scheme,
                           max_probes=max_probes, slots=slots)


def group_queries(keys, live):
    """Group duplicate query keys; returns ``(is_rep, rep_of)`` in batch
    order (``rep_of`` is ``n`` for elements whose key has no live
    occurrence)."""
    is_rep, rep_of, _, _ = bulk._group_fast(keys, live)
    return is_rep, rep_of


def _locate_reps(table, keys, live):
    """One walk per distinct live key: ``(rep_of, rep_idx, found, slot)``,
    with ``found`` / ``slot`` aligned to ``rep_idx``."""
    is_rep, rep_of = group_queries(keys, live)
    rep_idx = torch.nonzero(is_rep).squeeze(1)
    _, found, slot = _lookup(table, keys[rep_idx], slots=True)
    return rep_of, rep_idx, found, slot


def retrieve_single(table, keys):
    """``(values, found)``: int32 value words (0 where absent) and bools."""
    values, found, _ = _lookup(table, keys)
    return values, found


def contains_single(table, keys):
    return _lookup(table, keys)[1]


def erase_single(table, keys, mask=None):
    """Tombstone the slot of every distinct live key found; returns
    ``(table, erased)`` with the live count reduced by the keys erased."""
    n = keys.shape[0]
    if n == 0:
        return table, torch.zeros((0,), dtype=torch.bool, device=keys.device)
    live = (torch.ones((n,), dtype=torch.bool, device=keys.device)
            if mask is None else mask)
    rep_of, rep_idx, found, slot = _locate_reps(table, keys, live)
    table.ops.tombstone_slots(table.store, slot[found])
    matched = torch.zeros((n,), dtype=torch.bool, device=keys.device)
    matched[rep_idx] = found
    erased = live & matched[rep_of.clamp(max=n - 1)] & (rep_of < n)
    count = table.count - int(found.sum())
    return dataclasses.replace(table, count=count), erased
