"""SingleValueHashTable — open addressing with COPS probing, in PyTorch.

The port of ``repro.core.single_value`` for 1-word u32 keys and values on
the SOA store.  A table lives on one device, chosen at ``create``:
``device=None`` means the CUDA card, and there is no fallback to the CPU
(pass ``device="cpu"`` to run the plain tensor versions of the kernels, as
the tests do).  Every operation runs on the device of the table's tensors.

Semantics are the JAX package's (paper §IV-B.3-5):

- ``insert`` upserts: a present key has its value overwritten and reports
  ``STATUS_UPDATED``; an absent key claims the earliest EMPTY or TOMBSTONE
  slot of its walk, which runs on to a match or a window holding an EMPTY
  first, so every live key stays at or before the first EMPTY window of
  its walk.  Duplicates within a batch behave as consecutive upserts.
- ``retrieve`` / ``contains`` stop a walk at a match or an EMPTY window.
- ``erase`` writes TOMBSTONEs (§IV-B.5).

Unlike the JAX package, ``insert`` and ``erase`` update the store tensors
**in place** (no table-sized copy per batch) and return a table object
that shares them with the argument, carrying the new ``count``.

Key and value batches are u32 words: numpy ``uint32`` arrays or torch
``int32`` / ``uint32`` tensors (see ``common.to_words``).  With 1-word
keys the probe word a walk hashes is the key itself (``common.as_u32``).
Values come back as int32 tensors holding the u32 bits
(``common.to_numpy_u32`` reads them as numpy u32).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import bulk, bulk_retrieve, layouts, probing
from repro_torch.core.common import (
    DEFAULT_SEED,
    DEFAULT_WINDOW,
    table_geometry,
    to_words,
)

#: what the port does not carry yet -> the ROADMAP.md item that brings it
_NOT_PORTED = {
    "key_words": "queue 1 item 2 (wide keys and multi-word values)",
    "value_words": "queue 1 item 2 (wide keys and multi-word values)",
    "quadratic": "queue 1 item 1b (the rest of the single-value table)",
    "layout": "queue 1 item 1b (the rest of the single-value table)",
    "bucketed": "queue 1 item 4 (high-load lane: bucketed, quotient)",
}


@dataclasses.dataclass
class SingleValueHashTable:
    store: dict                 # {"keys": (1, p, W), "values": (1, p, W)} int32
    count: int                  # live keys
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


def _refuse(what: str, detail: str):
    raise NotImplementedError(
        f"{detail} is not ported to repro_torch yet: see ROADMAP.md "
        f"{_NOT_PORTED[what]}")


def resolve_device(device) -> torch.device:
    """``None`` -> the CUDA card; raises when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)


def check_ported(key_words: int, value_words: int, scheme: str,
                 layout: str) -> None:
    """Raise for a configuration the port does not carry: ValueError if
    the JAX package has no such option, NotImplementedError naming the
    ROADMAP.md item that brings it otherwise."""
    if key_words != 1:
        _refuse("key_words", f"key_words={key_words}")
    if value_words != 1:
        _refuse("value_words", f"value_words={value_words}")
    if scheme not in probing.SCHEMES:
        raise ValueError(f"scheme {scheme!r} not in {probing.SCHEMES}")
    if scheme in ("quadratic", "bucketed"):
        _refuse(scheme, f"scheme {scheme!r}")
    if layout != "soa":
        if layout not in layouts.LAYOUTS:
            raise ValueError(f"layout {layout!r} not in {layouts.LAYOUTS}")
        _refuse("bucketed" if layout.startswith("bucketed") else "layout",
                f"layout {layout!r}")


def create(min_capacity: int, *, window: int = DEFAULT_WINDOW,
           scheme: str = "cops", seed: int = DEFAULT_SEED,
           max_probes: int | None = None, device=None, key_words: int = 1,
           value_words: int = 1, layout: str = "soa",
           ) -> SingleValueHashTable:
    """Create an empty table with capacity >= min_capacity rounded to p*W, p prime."""
    check_ported(key_words, value_words, scheme, layout)
    device = resolve_device(device)
    num_rows, _ = table_geometry(min_capacity, window)
    ops = layouts.SoaOps(num_rows, window, key_words, value_words)
    return SingleValueHashTable(
        store=ops.create(device), count=0, num_rows=num_rows, window=window,
        key_words=key_words, value_words=value_words, scheme=scheme,
        layout=layout, seed=seed, max_probes=int(max_probes or num_rows))


# ---------------------------------------------------------------------------
# normalization helpers
# ---------------------------------------------------------------------------

def normalize_words(x, words: int, name: str, device) -> torch.Tensor:
    """Accept (n,) or (n, 1) u32 words; return (n,) int32 on ``device``."""
    x = to_words(x, device)
    if x.ndim == 2:
        if x.shape[1] != 1:
            _refuse("key_words" if name == "keys" else "value_words",
                    f"{name} with {x.shape[1]} words")
        x = x[:, 0]
    if x.ndim != 1:
        raise ValueError(f"{name} must be (n,) or (n, {words}), got {tuple(x.shape)}")
    return x.contiguous()


def normalize_key_batch(x, words: int, device, name: str = "keys") -> torch.Tensor:
    """``normalize_words`` for 1-word key batches."""
    return normalize_words(x, words, name, device)


def normalize_mask(mask, n: int, device):
    if mask is None:
        return None
    if isinstance(mask, np.ndarray):
        mask = torch.from_numpy(mask)
    mask = mask.to(device=device, dtype=torch.bool)
    if mask.shape != (n,):
        raise ValueError(f"mask must be ({n},), got {tuple(mask.shape)}")
    return mask


# ---------------------------------------------------------------------------
# operations
# ---------------------------------------------------------------------------

def insert(table: SingleValueHashTable, keys, values, mask=None):
    """Batch upsert. Returns (table, status (n,) int32) — see STATUS_* codes."""
    keys = normalize_key_batch(keys, table.key_words, table.device)
    values = normalize_words(values, table.value_words, "values", table.device)
    if values.shape != keys.shape:
        raise ValueError(f"{values.shape[0]} values for {keys.shape[0]} keys")
    mask = normalize_mask(mask, keys.shape[0], table.device)
    return bulk.insert_single(table, keys, values, mask)


def retrieve(table: SingleValueHashTable, keys):
    """Batch lookup -> (values (n,) int32 u32 bits, 0 where absent; found (n,) bool)."""
    keys = normalize_key_batch(keys, table.key_words, table.device)
    return bulk_retrieve.retrieve_single(table, keys)


def contains(table: SingleValueHashTable, keys) -> torch.Tensor:
    keys = normalize_key_batch(keys, table.key_words, table.device)
    return bulk_retrieve.contains_single(table, keys)


def erase(table: SingleValueHashTable, keys, mask=None):
    """Tombstone matching slots (paper §IV-B.5). Returns (table, erased_mask)."""
    keys = normalize_key_batch(keys, table.key_words, table.device)
    mask = normalize_mask(mask, keys.shape[0], table.device)
    return bulk_retrieve.erase_single(table, keys, mask)
