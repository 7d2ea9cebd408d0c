"""DISTINCT / dedup on a hash set, ``repro.relational.distinct``.

``hashset.add`` reports per element whether its key claimed a fresh slot:
``STATUS_INSERTED`` is the first occurrence.  On top of that:

- ``first_occurrence`` — the streaming dedup mask against a running set
  (feed batch after batch; duplicates across batches are caught);
- ``distinct`` — one-shot compaction of the unique keys into an
  ``out_capacity``-row output (the mask's cumulative sum is the layout).

Composite keys: ``distinct`` takes a tuple of u32 columns (``key_words``
inferred) and returns the unique keys as a tuple of columns.  Sets live
on the CUDA card unless ``device="cpu"``.
"""

from __future__ import annotations

import torch

from repro_torch.core import hashset as hs
from repro_torch.core import single_value as sv
from repro_torch.core.common import DEFAULT_SEED, DEFAULT_WINDOW
from repro_torch.relational.util import (  # noqa: F401 (compact re-exported)
    capacity_for,
    compact,
    unpack_columns,
)

DistinctSet = hs.HashSet


def create(min_capacity: int, *, key_words: int = 1,
           window: int = DEFAULT_WINDOW, scheme: str = "cops",
           layout: str = "soa", seed: int = DEFAULT_SEED,
           max_probes: int | None = None, device=None) -> DistinctSet:
    return hs.create(min_capacity, key_words=key_words, window=window,
                     scheme=scheme, layout=layout, seed=seed,
                     max_probes=max_probes, device=device)


def first_occurrence(dset: DistinctSet, keys, mask=None,
                     ) -> tuple[DistinctSet, torch.Tensor]:
    """Streaming dedup: True where the key was never seen before, in this
    batch or any earlier one fed into ``dset``."""
    return hs.add(dset, keys, mask=mask)


def distinct(keys, out_capacity: int, *, key_words: int | None = None,
             window: int = DEFAULT_WINDOW, load: float = 0.5,
             capacity: int | None = None, mask=None, device=None):
    """One-shot DISTINCT: (unique_keys, n_unique, first_occurrence_mask).

    ``unique_keys`` come in first-occurrence order, shaped like the input:
    a tuple of columns for tuple input, (out_capacity,) for 1-word input,
    else (out_capacity, key_words) planes; rows past ``n_unique`` (a 0-d
    int32 tensor) are zero.  ``key_words`` is inferred when omitted.
    """
    as_columns = isinstance(keys, tuple)
    device = sv.resolve_device(device)
    keys_n, key_words = sv.normalize_keys(keys, key_words, device)
    if capacity is None:
        capacity = capacity_for(keys_n.shape[0], load, window)
    dset = create(capacity, key_words=key_words, window=window, device=device)
    _, fresh = first_occurrence(dset, keys_n, mask=mask)
    packed, n_unique = compact(keys_n, fresh, out_capacity)
    if as_columns:
        return unpack_columns(packed), n_unique, fresh
    return packed, n_unique, fresh
