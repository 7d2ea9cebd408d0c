"""Hash joins (inner / left-outer / semi / anti), ``repro.relational.join``.

The classic two-phase hash join on the port's tables:

- **build** — every build-side row goes into a ``MultiValueHashTable`` as
  a (key, row index) pair (``multi_value.insert``: the ``cops_append``
  kernel on the card), so duplicate build keys take slots of their own
  and N:M joins follow from the multi-value semantics;
- **probe** — the paper's counting pass and prefix-sum output layout
  (§IV-B.4): inner and left go through ``multi_value.retrieve_all``, semi
  and anti through ``count_values`` (the ``cops_retrieve`` walk on the
  card); duplicate probe keys walk the table once.  ``out_capacity`` is
  the pre-sized output, as in the paper; size it with ``count_matches``.

Tombstoned (erased) build rows drop out of every flavour.  Keys may be
composite: a tuple of u32 columns or an (n, key_words) plane batch, with
``key_words`` inferred.  On the CPU the output is bit-exact against the
JAX package, the order of a probe row's matches included (build-batch
order).  On the card the append's concurrent claims may place a key's
pairs in another order, so a probe row's matches are the same multiset in
an order that may differ.  ``shard_join`` and ``join_partitioned`` wait
for ROADMAP.md queue 1 item 9 (distribution) and are not defined.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import multi_value as mv
from repro_torch.core import single_value as sv
from repro_torch.core.common import DEFAULT_SEED, DEFAULT_WINDOW, to_words
from repro_torch.relational.util import capacity_for, compact

HOW = ("inner", "left", "semi", "anti")

#: build_idx of output rows with no build-side match (left / semi / anti)
NO_MATCH = -1


@dataclasses.dataclass
class JoinResult:
    """Materialized join output of ``out_capacity`` rows (all tensors on
    the table's device).

    - ``build_idx`` (out_capacity,) int32 — build-side row index per
      output row; ``NO_MATCH`` for unmatched left-outer rows and for
      semi / anti, which emit probe rows only.
    - ``probe_idx`` (out_capacity,) int32 — probe-side row index.
    - ``valid`` (out_capacity,) bool — the live output rows.
    - ``matched`` (n_probe,) bool — per probe row: had >= 1 build match.
    - ``total`` () int32 — live output rows; past ``out_capacity`` the
      tail was dropped.
    """
    build_idx: torch.Tensor
    probe_idx: torch.Tensor
    valid: torch.Tensor
    matched: torch.Tensor
    total: torch.Tensor


def build(build_keys, *, capacity: int | None = None,
          key_words: int | None = None, window: int = DEFAULT_WINDOW,
          scheme: str = "cops", layout: str = "soa", seed: int = DEFAULT_SEED,
          max_probes: int | None = None, load: float = 0.5, mask=None,
          row_ids=None, device=None,
          ) -> tuple[mv.MultiValueHashTable, torch.Tensor]:
    """Build phase: key -> build row index in a ``MultiValueHashTable``.
    ``row_ids`` overrides the stored row indices.  Returns (table,
    insert_status)."""
    device = sv.resolve_device(device)
    keys, key_words = sv.normalize_keys(build_keys, key_words, device,
                                        "build_keys")
    n = keys.shape[0]
    if capacity is None:
        capacity = capacity_for(n, load, window)
    table = mv.create(capacity, key_words=key_words, value_words=1,
                      window=window, scheme=scheme, layout=layout, seed=seed,
                      max_probes=max_probes, device=device)
    if row_ids is None:
        row_ids = torch.arange(n, dtype=torch.int32, device=device)
    return mv.insert(table, keys, row_ids, mask=mask)


def _live(n, mask, device):
    mask = sv.normalize_mask(mask, n, device)
    return (torch.ones((n,), dtype=torch.bool, device=device)
            if mask is None else mask)


def count_matches(table: mv.MultiValueHashTable, probe_keys,
                  how: str = "inner", mask=None) -> torch.Tensor:
    """Output rows each probe row will emit (int32) — the paper's
    counting pass; sum it to size ``out_capacity`` for ``probe``."""
    keys = sv.normalize_key_batch(probe_keys, table.key_words, table.device,
                                  "probe_keys")
    counts = mv.count_values(table, keys, mask=mask)
    live = _live(keys.shape[0], mask, table.device)
    if how == "inner":
        return counts
    if how == "left":
        return torch.where(live, counts.clamp(min=1), 0)
    if how == "semi":
        return ((counts > 0) & live).to(torch.int32)
    if how == "anti":
        return ((counts == 0) & live).to(torch.int32)
    raise ValueError(f"how={how!r} not in {HOW}")


def _segment_of(offsets: torch.Tensor, out_capacity: int) -> torch.Tensor:
    """Probe row owning each output row: row i owns [offsets[i],
    offsets[i + 1])."""
    j = torch.arange(out_capacity, dtype=offsets.dtype, device=offsets.device)
    return torch.searchsorted(offsets[1:], j, right=True).to(torch.int32)


def probe(table: mv.MultiValueHashTable, probe_keys, out_capacity: int,
          how: str = "inner", mask=None) -> JoinResult:
    """Probe phase: (build_idx, probe_idx) rows per ``how``.  ``mask``
    drops probe rows entirely (they match and emit nothing)."""
    if how not in HOW:
        raise ValueError(f"how={how!r} not in {HOW}")
    dev = table.device
    keys = sv.normalize_key_batch(probe_keys, table.key_words, dev,
                                  "probe_keys")
    n = keys.shape[0]
    mask = sv.normalize_mask(mask, n, dev)
    live = _live(n, mask, dev)
    rows = torch.arange(out_capacity, dtype=torch.int32, device=dev)
    no_match = torch.full((out_capacity,), NO_MATCH, dtype=torch.int32,
                          device=dev)

    if how in ("semi", "anti"):
        counts = mv.count_values(table, keys, mask=mask)
        matched = (counts > 0) & live
        sel = matched if how == "semi" else (counts == 0) & live
        probe_idx, total = compact(
            torch.arange(n, dtype=torch.int32, device=dev), sel,
            out_capacity, fill=NO_MATCH)
        valid = rows < total.clamp(max=out_capacity)
        return JoinResult(build_idx=no_match, probe_idx=probe_idx,
                          valid=valid, matched=matched, total=total)

    # inner / left: the matching build row ids in the counting-pass layout
    vals, offsets, counts = mv.retrieve_all(table, keys, out_capacity,
                                            mask=mask)
    matched = (counts > 0) & live
    if how == "inner":
        total = offsets[n]
        valid = rows < total.clamp(max=out_capacity)
        seg = _segment_of(offsets, out_capacity)
        return JoinResult(build_idx=torch.where(valid, vals, NO_MATCH),
                          probe_idx=torch.where(valid, seg, NO_MATCH),
                          valid=valid, matched=matched, total=total)

    # left outer: an unmatched live probe row emits one NO_MATCH row
    counts_lo = torch.where(live, counts.clamp(min=1), 0)
    offs_lo = torch.zeros((n + 1,), dtype=torch.int32, device=dev)
    offs_lo[1:] = torch.cumsum(counts_lo, 0)
    total = offs_lo[n]
    valid = rows < total.clamp(max=out_capacity)
    seg = _segment_of(offs_lo, out_capacity)
    if n:
        at = seg.clamp(max=n - 1).long()    # rows past the total: any row
        rank = rows - offs_lo[at]
        has_match = matched[at]
        inner_pos = (offsets[at] + rank).clamp(0, max(out_capacity - 1, 0))
        gathered = vals[inner_pos.long()]
    else:
        has_match = torch.zeros((out_capacity,), dtype=torch.bool, device=dev)
        gathered = no_match
    return JoinResult(
        build_idx=torch.where(valid & has_match, gathered, NO_MATCH),
        probe_idx=torch.where(valid, seg, NO_MATCH), valid=valid,
        matched=matched, total=total)


def hash_join(build_keys, probe_keys, out_capacity: int, how: str = "inner",
              *, key_words: int | None = None, window: int = DEFAULT_WINDOW,
              scheme: str = "cops", load: float = 0.5,
              capacity: int | None = None, build_mask=None, probe_mask=None,
              device=None) -> JoinResult:
    """One-shot build + probe.  Composite keys: tuples of u32 columns for
    both sides (``key_words`` inferred)."""
    table, _ = build(build_keys, capacity=capacity, key_words=key_words,
                     window=window, scheme=scheme, load=load, mask=build_mask,
                     device=device)
    return probe(table, probe_keys, out_capacity, how=how, mask=probe_mask)


def gather_payload(result: JoinResult, build_values=None, probe_values=None,
                   fill=0):
    """Materialize joined payload columns: (build_cols, probe_cols), each
    None if its values were not given; NO_MATCH and padding rows get
    ``fill``.  Values are tensors or numpy arrays of any dtype (u32
    arrays as int32 words)."""
    dev = result.valid.device

    def take(values, idx):
        if isinstance(values, np.ndarray):
            values = (to_words(values) if values.dtype == np.uint32
                      else torch.from_numpy(np.ascontiguousarray(values)))
        values = values.to(dev)
        ok = (idx >= 0) & result.valid
        got = values[idx.clamp(0, values.shape[0] - 1).long()]
        ok = ok.reshape((-1,) + (1,) * (got.ndim - 1))
        return torch.where(ok, got, torch.tensor(fill, dtype=got.dtype,
                                                 device=dev))

    bcols = None if build_values is None else take(build_values,
                                                   result.build_idx)
    pcols = None if probe_values is None else take(probe_values,
                                                   result.probe_idx)
    return bcols, pcols
