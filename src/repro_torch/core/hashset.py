"""HashSet — keys only, each stored once (paper §IV), ``repro.core.hashset``.

A ``SingleValueHashTable`` with no value word: the store has no value
plane, and the insert and lookup kernels run with a null one
(``kernels.cops.ops``), so probing, claims and erase are the table's own,
two-word keys included (``key_words=2`` with u64 keys, (n, 2) planes or
column tuples).  Sets live on the CUDA card unless ``device="cpu"``.
"""

from __future__ import annotations

import torch

from repro_torch.core import single_value as sv
from repro_torch.core.common import DEFAULT_SEED, DEFAULT_WINDOW, STATUS_INSERTED

HashSet = sv.SingleValueHashTable


def create(min_capacity: int, *, key_words: int = 1,
           window: int = DEFAULT_WINDOW, scheme: str = "cops",
           layout: str = "soa", seed: int = DEFAULT_SEED,
           max_probes: int | None = None, device=None) -> HashSet:
    if layout == "packed":
        raise ValueError("packed layout needs a value word; use soa/aos for HashSet")
    return sv.create(min_capacity, key_words=key_words, value_words=0,
                     window=window, scheme=scheme, layout=layout, seed=seed,
                     max_probes=max_probes, device=device)


def add(hs: HashSet, keys, mask=None) -> tuple[HashSet, torch.Tensor]:
    """Insert keys; returns (set, newly_added (n,) bool): True where the
    element claimed a fresh slot, i.e. the first live occurrence of a key
    the set did not hold."""
    keys = sv.normalize_key_batch(keys, hs.key_words, hs.device)
    vals = torch.zeros((keys.shape[0], 0), dtype=torch.int32, device=hs.device)
    hs, status = sv.insert(hs, keys, vals, mask)
    return hs, status == STATUS_INSERTED


def contains(hs: HashSet, keys) -> torch.Tensor:
    return sv.contains(hs, keys)


def remove(hs: HashSet, keys, mask=None) -> tuple[HashSet, torch.Tensor]:
    return sv.erase(hs, keys, mask)


def size(hs: HashSet) -> int:
    return hs.count
