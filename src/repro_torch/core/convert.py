"""State bridge between the JAX package's tables and the port's.

A JAX ``SingleValueHashTable`` or ``MultiValueHashTable`` hands over its
state as numpy arrays (``np.asarray(t.store["keys"])``,
``np.asarray(t.store["values"])``, ``int(t.count)``) plus its static
fields; ``table_from_numpy`` / ``multi_table_from_numpy`` build the port's
table from exactly that, tombstones included, and ``table_to_numpy`` goes
back from either.  A ``BucketListHashTable`` crosses the same way with
its key store's planes (the values are the two handle words), its
``pool``, ``alloc_top`` and schedule (``bucket_table_from_numpy`` /
``bucket_table_to_numpy``).  A bloom filter crosses as the JAX filter's
``(num_blocks, block_bits)`` u8 bits, which the port packs into its u32
words (``bloom_from_numpy`` / ``bloom_to_numpy``).  Neither side imports
the other: the bridge speaks numpy only.
"""

from __future__ import annotations

import numpy as np

import torch

from repro_torch.core import bloom, bucket_list, multi_value, single_value
from repro_torch.core.common import to_numpy_u32, to_words


def _from_numpy(create, keys_planes, value_planes, count, *, num_rows,
                window, scheme, seed, max_probes, device):
    keys_planes = np.asarray(keys_planes)
    value_planes = np.asarray(value_planes)
    if keys_planes.shape[1:] != (num_rows, window):
        raise ValueError(f"key planes {keys_planes.shape} do not match "
                         f"({num_rows}, {window})")
    if value_planes.shape[1:] != keys_planes.shape[1:]:
        raise ValueError(f"value planes {value_planes.shape} do not match "
                         f"key planes {keys_planes.shape}")
    table = create(
        num_rows * window, window=window, scheme=scheme, seed=seed,
        max_probes=max_probes, device=device, key_words=keys_planes.shape[0],
        value_words=value_planes.shape[0])
    if table.num_rows != num_rows:
        raise ValueError(f"{num_rows} rows is not the prime geometry of "
                         f"capacity {num_rows * window}")
    dev = table.device
    table.store["keys"].copy_(to_words(keys_planes, dev))
    table.store["values"].copy_(to_words(value_planes, dev))
    table.count = int(count)
    return table


def table_from_numpy(keys_planes: np.ndarray, value_planes: np.ndarray,
                     count: int, *, num_rows: int, window: int, scheme: str,
                     seed: int, max_probes: int, device=None,
                     ) -> single_value.SingleValueHashTable:
    """The port's single-value table holding the given (key_words, p, W) /
    (value_words, p, W) u32 planes and live ``count``."""
    return _from_numpy(single_value.create, keys_planes, value_planes, count,
                       num_rows=num_rows, window=window, scheme=scheme,
                       seed=seed, max_probes=max_probes, device=device)


def multi_table_from_numpy(keys_planes: np.ndarray, value_planes: np.ndarray,
                           count: int, *, num_rows: int, window: int,
                           scheme: str, seed: int, max_probes: int,
                           device=None) -> multi_value.MultiValueHashTable:
    """The port's multi-value table holding the given planes and live pair
    ``count``."""
    return _from_numpy(multi_value.create, keys_planes, value_planes, count,
                       num_rows=num_rows, window=window, scheme=scheme,
                       seed=seed, max_probes=max_probes, device=device)


def table_to_numpy(table) -> dict:
    """``{"keys", "values"}`` u32 planes and ``count`` of a port table of
    either kind: the inverse of both bridges above."""
    return {"keys": to_numpy_u32(table.store["keys"]),
            "values": to_numpy_u32(table.store["values"]),
            "count": int(table.count)}


def bucket_table_from_numpy(keys_planes: np.ndarray, value_planes: np.ndarray,
                            count: int, pool: np.ndarray, alloc_top: int, *,
                            num_rows: int, window: int, scheme: str,
                            seed: int, max_probes: int, s0: int,
                            growth: float, sizes=None, cum=None,
                            device=None) -> bucket_list.BucketListHashTable:
    """The port's bucket list holding the given key-store planes ((1, p,
    W) keys, (2, p, W) handle words), live key ``count``, (P,) u32
    ``pool`` and ``alloc_top``.  ``sizes`` / ``cum``, where given, must be
    the schedule that ``s0``, ``growth`` and the pool's size give."""
    pool = np.asarray(pool)
    key_store = _from_numpy(single_value.empty_table, keys_planes,
                            value_planes, count, num_rows=num_rows,
                            window=window, scheme=scheme, seed=seed,
                            max_probes=max_probes, device=device)
    if key_store.value_words != 2 or key_store.key_words != 1:
        raise ValueError(f"a bucket list's key store holds 1-word keys and "
                         f"2-word handles, got {key_store.key_words} and "
                         f"{key_store.value_words}")
    schedule = bucket_list.growth_schedule(s0, growth, pool.shape[0])
    if sizes is not None and (tuple(sizes), tuple(cum)) != schedule:
        raise ValueError(f"schedule {sizes} / {cum} is not growth_schedule("
                         f"{s0}, {growth}, {pool.shape[0]})")
    return bucket_list.BucketListHashTable(
        key_store=key_store, pool=to_words(pool, key_store.device).clone(),
        alloc_top=int(alloc_top), pool_capacity=pool.shape[0],
        sizes=schedule[0], cum=schedule[1], s0=s0, growth=growth)


def bucket_table_to_numpy(table: bucket_list.BucketListHashTable) -> dict:
    """The inverse of ``bucket_table_from_numpy``: ``table_to_numpy`` of
    the key store plus ``pool`` (u32) and ``alloc_top``."""
    return {**table_to_numpy(table.key_store), "pool": to_numpy_u32(table.pool),
            "alloc_top": int(table.alloc_top)}


def bloom_from_numpy(bits: np.ndarray, *, k: int, seed: int,
                     device=None) -> bloom.BloomFilter:
    """The port's filter holding a JAX filter's state: its (num_blocks,
    block_bits) u8 bits in {0, 1} (``np.asarray(f.bits)``), packed into
    u32 words."""
    bits = np.asarray(bits)
    if bits.ndim != 2 or bits.dtype != np.uint8:
        raise ValueError(f"expected (num_blocks, block_bits) uint8 bits, got "
                         f"{bits.shape} {bits.dtype}")
    from repro_torch.kernels.bloom import ref
    words = ref.pack_bits(torch.from_numpy(bits.copy()))
    return bloom.unpack_words(words.to(single_value.resolve_device(device)),
                              bits.shape[1], k, seed)


def bloom_to_numpy(f: bloom.BloomFilter) -> np.ndarray:
    """The inverse of ``bloom_from_numpy``: the filter's (num_blocks,
    block_bits) u8 bits, the JAX filter's ``bits``."""
    return bloom.bits(f).cpu().numpy()
