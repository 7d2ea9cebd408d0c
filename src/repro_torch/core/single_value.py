"""SingleValueHashTable — open addressing with COPS probing, in PyTorch.

The port of ``repro.core.single_value`` on the SOA store, for 1-word u32
keys and for two-word keys (u64 keys and two-column composite keys), with
0, 1 or 2 value words: one for the plain table and the counting table
(``core.counting``), none for the hash set (``core.hashset``), two for the
group-by (``relational.groupby``: accumulator and count).  A table lives
on one device, chosen at ``create``:
``device=None`` means the CUDA card, and there is no fallback to the CPU
(pass ``device="cpu"`` to run the plain tensor versions of the kernels, as
the tests do).  Every operation runs on the device of the table's tensors.

Semantics are the JAX package's (paper §IV-B.3-5):

- ``insert`` upserts: a present key has its value overwritten and reports
  ``STATUS_UPDATED``; an absent key claims the earliest EMPTY or TOMBSTONE
  slot of its walk, which runs on to a match or a window holding an EMPTY
  first, so every live key stays at or before the first EMPTY window of
  its walk.  Duplicates within a batch behave as consecutive upserts.
- ``update_values`` is the read-modify-write upsert: a present key folds
  the batch's operands into its value words, an absent key claims a slot
  holding ``init`` (with the rest of its duplicates' operands folded in).
  The fold and its pre-aggregation are per-word specs (``bulk.FOLD_OPS``,
  ``bulk.COMBINE_OPS``), not callables.
- ``retrieve`` / ``contains`` stop a walk at a match or an EMPTY window.
- ``erase`` writes TOMBSTONEs into every key plane (§IV-B.5).

Unlike the JAX package, ``insert`` and ``erase`` update the store tensors
**in place** (no table-sized copy per batch) and return a table object
that shares them with the argument, carrying the new ``count``.

Key batches (``normalize_key_batch``) are u32 words — numpy ``uint32``
arrays or torch ``int32`` / ``uint32`` tensors, (n,) or (n, key_words) —
and, for ``key_words == 2``, also numpy / torch ``uint64`` keys and tuples
of two (n,) u32 columns (``hashing.pack_columns``).  Key plane 0 holds the
low word and the sentinels.  The probe word a walk hashes is the key
itself for 1-word keys and ``hashing.combine_planes(hi, lo)`` for two
(``key_hash_word``).  Values come back as int32 tensors holding the u32
bits (``common.to_numpy_u32`` reads them as numpy u32).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import bulk, bulk_retrieve, hashing, layouts, probing
from repro_torch.core.common import (
    DEFAULT_SEED,
    DEFAULT_WINDOW,
    as_u32,
    split_u64,
    table_geometry,
    to_words,
)

#: what the port does not carry yet -> the ROADMAP.md item that brings it
_NOT_PORTED = {
    "key_words": "queue 1 item 2b (keys wider than two words, "
                 "multi-word values)",
    "value_words": "queue 1 item 2b (keys wider than two words, "
                   "values wider than two words)",
    "insert_words": "queue 1 item 2b (keys wider than two words, "
                    "values wider than two words): the insert kernels "
                    "store one value word",
    "quadratic": "queue 1 item 1b (the rest of the single-value table)",
    "update": "queue 1 item 1b (the rest of the single-value table): "
              "the sequential update_values without a combiner",
    "layout": "queue 1 item 1b (the rest of the single-value table)",
    "bucketed": "queue 1 item 4 (high-load lane: bucketed, quotient)",
}


@dataclasses.dataclass
class SingleValueHashTable:
    store: dict                 # {"keys": (kw, p, W), "values": (vw, p, W)} int32
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
                 layout: str, value_words_ported=(1,)) -> None:
    """Raise for a configuration the port does not carry: ValueError if
    the JAX package has no such option, NotImplementedError naming the
    ROADMAP.md item that brings it otherwise.  ``value_words_ported`` are
    the value widths the caller's table carries."""
    if key_words < 1:
        raise ValueError(f"key_words={key_words} must be positive")
    if key_words > 2:
        _refuse("key_words", f"key_words={key_words}")
    if value_words < 0:
        raise ValueError(f"value_words={value_words} must not be negative")
    if value_words not in value_words_ported:
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
    """Create an empty table with capacity >= min_capacity rounded to p*W,
    p prime; 0, 1 or 2 value words."""
    check_ported(key_words, value_words, scheme, layout, (0, 1, 2))
    return empty_table(min_capacity, window=window, scheme=scheme, seed=seed,
                       max_probes=max_probes, device=device,
                       key_words=key_words, value_words=value_words)


def empty_table(min_capacity: int, *, window: int, scheme: str, seed: int,
                max_probes: int | None, device, key_words: int,
                value_words: int) -> SingleValueHashTable:
    """``create`` without its checks, on the SOA store: also builds the
    bucket list's key store, whose value is the two-word list handle
    (``value_words=2``, which ``insert`` refuses)."""
    device = resolve_device(device)
    num_rows, _ = table_geometry(min_capacity, window)
    ops = layouts.SoaOps(num_rows, window, key_words, value_words)
    return SingleValueHashTable(
        store=ops.create(device), count=0, num_rows=num_rows, window=window,
        key_words=key_words, value_words=value_words, scheme=scheme,
        layout="soa", seed=seed, max_probes=int(max_probes or num_rows))


# ---------------------------------------------------------------------------
# normalization helpers
# ---------------------------------------------------------------------------

def normalize_words(x, words: int, name: str, device) -> torch.Tensor:
    """Accept (n,) u32 words [words == 1] or (n, words); return a
    contiguous int32 tensor on ``device``, (n,) for one word and (n, words)
    otherwise.  Used for value batches too, so it makes no key-specific
    coercion (``normalize_key_batch`` does)."""
    x = to_words(x, device)
    if x.ndim == 1:
        x = x[:, None]
    if x.ndim != 2 or x.shape[1] != words:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, the table "
                         f"expects (n,) or (n, {words}) words")
    return (x[:, 0] if words == 1 else x).contiguous()


def as_key_planes(x):
    """Coerce the composite key spellings to a plane batch (others pass
    through unchanged):

    - a tuple of (n,) u32 columns (numpy arrays or torch tensors) packs via
      ``hashing.pack_columns``, column 0 most significant;
    - numpy ``uint64`` keys, or a torch ``uint64`` tensor, split into the
      table-native (lo, hi) planes (``common.split_u64``).
    """
    if (isinstance(x, tuple) and len(x) > 0
            and all(isinstance(c, (np.ndarray, torch.Tensor)) and c.ndim == 1
                    for c in x)):
        return hashing.pack_columns(x)
    if ((isinstance(x, np.ndarray) and x.dtype == np.uint64)
            or (isinstance(x, torch.Tensor) and x.dtype == torch.uint64)):
        hi, lo = split_u64(x)
        return torch.stack([lo, hi], dim=1)
    return x


def normalize_key_batch(x, words: int, device, name: str = "keys") -> torch.Tensor:
    """``normalize_words`` for key batches, taking every key spelling
    (``as_key_planes``): (n,) int32 for 1-word keys, (n, words) planes
    otherwise."""
    return normalize_words(as_key_planes(x), words, name, device)


def normalize_keys(x, words: int | None, device, name: str = "keys",
                   ) -> tuple[torch.Tensor, int]:
    """``normalize_key_batch`` that infers the word count when ``words``
    is None, for the entry points that build their own table (the
    relational operators): a tuple of N columns gives N, an (n, kw) plane
    batch kw, numpy / torch uint64 2, a flat (n,) batch 1.  Returns
    ``(keys, key_words)``."""
    x = as_key_planes(x)
    if words is None:
        words = x.shape[-1] if np.ndim(x) == 2 else 1
    return normalize_words(x, words, name, device), words


def key_hash_word(keys: torch.Tensor) -> torch.Tensor:
    """The u32 probe word (int64) a walk derives its rows from: the key
    itself for (n,) 1-word keys, the ``hashing.combine_planes`` fold of
    the planes of (n, kw) keys."""
    if keys.ndim == 1:
        return as_u32(keys)
    word = as_u32(keys[:, 0])
    for w in range(1, keys.shape[1]):
        word = hashing.combine_planes(keys[:, w], word)
    return word


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

def insert(table: SingleValueHashTable, keys, values, mask=None,
           stats: bool = False):
    """Batch upsert. Returns (table, status (n,) int32) — see STATUS_* codes.
    ``values`` are (n, 0) for a table with no value word (a hash set).
    ``stats=True`` appends an ``obs.metrics.TableStats`` (measured after the
    insert, ``metrics.bolt_on_stats``)."""
    if table.value_words > 1:
        # the insert kernels store one value word, or none
        _refuse("insert_words", f"insert into value_words={table.value_words}")
    keys = normalize_key_batch(keys, table.key_words, table.device)
    values = normalize_words(values, table.value_words, "values", table.device)
    if values.shape[0] != keys.shape[0]:
        raise ValueError(f"{values.shape[0]} values for {keys.shape[0]} keys")
    mask = normalize_mask(mask, keys.shape[0], table.device)
    out = bulk.insert_single(table, keys, values, mask)
    return _with_stats(stats, out, keys, out[1], mask)


def _with_stats(stats: bool, out: tuple, keys, status=None, mask=None,
                table=None):
    """``out``, with ``stats`` the ``TableStats`` of the op appended: its
    batch ``keys`` walked against the post-op store of ``table`` (default:
    the table ``out`` starts with)."""
    if not stats:
        return out
    from repro_torch.obs import metrics
    return out + (metrics.bolt_on_stats(out[0] if table is None else table,
                                        keys, status=status, mask=mask),)


def retrieve(table: SingleValueHashTable, keys, stats: bool = False):
    """Batch lookup -> (values, found (n,) bool): int32 u32 bits, 0 where
    absent, (n,) for one value word and (n, value_words) otherwise;
    ``stats=True`` appends an ``obs.metrics.TableStats``."""
    keys = normalize_key_batch(keys, table.key_words, table.device)
    out = bulk_retrieve.retrieve_single(table, keys)
    return _with_stats(stats, out, keys, table=table)


def contains(table: SingleValueHashTable, keys) -> torch.Tensor:
    keys = normalize_key_batch(keys, table.key_words, table.device)
    return bulk_retrieve.contains_single(table, keys)


def erase(table: SingleValueHashTable, keys, mask=None):
    """Tombstone matching slots (paper §IV-B.5). Returns (table, erased_mask)."""
    keys = normalize_key_batch(keys, table.key_words, table.device)
    mask = normalize_mask(mask, keys.shape[0], table.device)
    return bulk_retrieve.erase_single(table, keys, mask)


def update_values(table: SingleValueHashTable, keys, update, init, mask=None,
                  values=None, combine=None, stats: bool = False):
    """Read-modify-write upsert: a present key's value becomes
    ``update(old, new)``, an absent key inserts ``init``.  The substrate of
    the counting table and the group-by.

    ``update`` and ``combine`` are per-value-word specs: ``update`` of
    ``bulk.FOLD_OPS`` (``add``, ``min``, ``max``, ``sat_add``, all on u32)
    and ``combine`` of ``bulk.COMBINE_OPS``, the associative pre-aggregation
    of the operand stream (``update(update(x, a), b) == update(x,
    combine(a, b))``), which says the duplicates of a key may fold in any
    order: the bulk engine walks one representative per distinct key and
    folds every other operand of its group into the representative's slot
    (the JAX engine folds ``combine`` of them in once; the two agree
    wherever ``combine`` meets that contract).  ``values`` carries a
    per-element operand (default: ``init``, broadcast to the batch).
    Returns (table, status (n,) int32), and with ``stats=True`` an
    ``obs.metrics.TableStats`` (whose ``fixpoint_iters`` is 0: see
    ``obs.metrics``).  Callables, the bitwise specs and ``combine=None``
    (the JAX package's sequential reference) are not ported.
    """
    if combine is None:
        _refuse("update", "update_values without a combiner")
    bulk.check_spec(update, bulk.FOLD_OPS, "update")
    bulk.check_spec(combine, bulk.COMBINE_OPS, "combine")
    update, combine = tuple(update), tuple(combine)
    vw = table.value_words
    if not 1 <= vw <= 2 or len(update) != vw or len(combine) != vw:
        raise ValueError(f"update_values needs one op per value word of a "
                         f"table with 1 or 2, got {update} / {combine} for "
                         f"value_words={vw}")
    keys = normalize_key_batch(keys, table.key_words, table.device)
    n = keys.shape[0]
    mask = normalize_mask(mask, n, table.device)
    if not isinstance(init, torch.Tensor):
        init = np.asarray(init, dtype=np.uint32)       # a scalar, or words
    init = normalize_words(torch.broadcast_to(
        to_words(init, table.device), (n,) if vw == 1 else (n, vw)),
        vw, "init", table.device)
    values = init if values is None else normalize_words(
        values, vw, "values", table.device)
    if values.shape[0] != n:
        raise ValueError(f"{values.shape[0]} values for {n} keys")
    two = (lambda x: x[:, None]) if vw == 1 else (lambda x: x)
    out = bulk.update_single(table, keys, update, two(init), two(values),
                             mask)
    return _with_stats(stats, out, keys, out[1], mask)


def insert_or_grow(table: SingleValueHashTable, keys, values, mask=None, *,
                   policy=None, max_attempts: int = 4):
    """``insert`` under the auto-growth policy: migrates (grow / compact)
    instead of ever returning ``STATUS_FULL`` while capacity headroom
    remains.  Host-side wrapper — see ``core.migrate``."""
    from repro_torch.core import migrate
    return migrate.insert_or_grow(
        table, keys, values, mask,
        policy=migrate.DEFAULT_POLICY if policy is None else policy,
        max_attempts=max_attempts)
