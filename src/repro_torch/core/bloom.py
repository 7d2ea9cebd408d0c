"""BloomFilter — blocked bloom filter, set membership with false positives.

The port of ``repro.core.bloom`` (see there for the blocked design and the
**staleness contract**: no false negatives, ever; an erase leaves the
filter permissive until ``rebuild_from_table`` resweeps the live set, so a
filter miss is proof of absence and a hit only a hint).

One difference in state: the reference keeps one u8 per bit, ``(num_blocks,
block_bits)``, and packs to u32 words only for its Pallas kernel.  The
port keeps the packed words themselves, ``(num_blocks, block_bits // 32)``
int32 tensors holding the u32 bits (bit j of a block in word j // 32 at
bit j % 32, the reference's ``pack_words``): 8x smaller, and what the
``bloom_insert`` / ``bloom_query`` kernels (``kernels.bloom.ops``) read and
write.  ``bits`` gives the reference's u8 view for comparisons.  Like the
port's tables, ``insert`` and ``rebuild_from_table`` update the words
**in place** and return the filter.  A filter lives on the CUDA card unless
``create`` is given ``device="cpu"``.

Keys are u32 words: numpy ``uint32`` / ``int32`` arrays, torch ``int32`` /
``uint32`` tensors, or int64 tensors holding u32 values (what
``single_value.key_hash_word`` returns).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.common import DEFAULT_SEED, as_word, next_prime, to_words
from repro_torch.kernels.bloom import ops, ref


@dataclasses.dataclass
class BloomFilter:
    words: torch.Tensor        # (num_blocks, block_bits // 32) int32 u32 bits
    num_blocks: int
    block_bits: int
    k: int
    seed: int

    @property
    def num_bits(self) -> int:
        return self.num_blocks * self.block_bits

    @property
    def device(self) -> torch.device:
        return self.words.device


def num_blocks_for(num_bits: int, block_bits: int = 512) -> int:
    """The prime block count of a filter of ``num_bits`` bits."""
    return next_prime(max(1, num_bits // block_bits))


def create(num_bits: int, *, k: int = 4, block_bits: int = 512,
           seed: int = DEFAULT_SEED, device=None) -> BloomFilter:
    """An empty filter of next_prime(num_bits // block_bits) blocks.
    ``block_bits`` must be a multiple of 32: the reference's bit view
    reduces positions mod ``block_bits`` and its kernel mod 32 · words,
    which agree only then."""
    from repro_torch.core.single_value import resolve_device
    if block_bits <= 0 or block_bits % 32:
        raise ValueError(f"block_bits={block_bits} must be a positive "
                         "multiple of 32")
    if k < 0:
        raise ValueError(f"k={k} must not be negative")
    num_blocks = num_blocks_for(num_bits, block_bits)
    words = torch.zeros((num_blocks, block_bits // 32), dtype=torch.int32,
                        device=resolve_device(device))
    return BloomFilter(words=words, num_blocks=num_blocks,
                       block_bits=block_bits, k=k, seed=seed)


def key_batch(keys, device) -> torch.Tensor:
    """(n,) int32 key words on ``device`` from any u32 spelling."""
    if isinstance(keys, torch.Tensor) and keys.dtype == torch.int64:
        keys = as_word(keys)
    keys = to_words(keys, device)
    if keys.ndim != 1:
        raise ValueError(f"bloom keys must be (n,) words, got "
                         f"{tuple(keys.shape)}")
    return keys


def _positions(f: BloomFilter, keys) -> tuple[torch.Tensor, torch.Tensor]:
    """(block_idx (n,), bit_idx (n, k)) int64 for each key."""
    return ref.positions(key_batch(keys, f.device), f.num_blocks,
                         f.block_bits, f.k, f.seed)


def insert(f: BloomFilter, keys, mask=None) -> BloomFilter:
    """Set each (unmasked) key's k bits, in place; returns ``f``."""
    return ops.insert(f, keys, mask)


def contains(f: BloomFilter, keys) -> torch.Tensor:
    """Membership query — false positives possible, false negatives never."""
    return ops.contains(f, keys)


def contains_stack(proto: BloomFilter, words_stack: torch.Tensor,
                   owners, keys) -> torch.Tensor:
    """Membership of each key in its *owner's* filter: ``words_stack`` is
    ``(P, num_blocks, words)``, one filter per shard with ``proto``'s
    geometry, and ``owners (n,)`` names the plane that answers each key
    (the sharded lookup's admission test).  One ``bloom_query`` launch for
    the whole batch; the reference gathers from stacked u8 planes."""
    keys = key_batch(keys, words_stack.device)
    if isinstance(owners, np.ndarray):
        owners = torch.from_numpy(owners.astype(np.int64))
    owners = owners.to(words_stack.device)
    return ops.query_words(words_stack, keys, k_hashes=proto.k,
                           seed=proto.seed, planes=owners)


def rebuild_from_table(f: BloomFilter, table) -> BloomFilter:
    """Clear ``f`` in place and advertise exactly the table's live keys:
    the compaction / load hook closing the staleness loop.  Inserts the
    folded key word (``single_value.key_hash_word``) of each live slot
    (``migrate.live_entries``), which is also what the elastic service's
    incremental inserts feed, so a rebuilt filter is a subset of the
    incremental one and never misses a live key."""
    from repro_torch.core import migrate
    from repro_torch.core import single_value as sv
    keys, _, live = migrate.live_entries(table)
    f.words.zero_()
    return insert(f, sv.key_hash_word(keys), mask=live)


def fill_fraction(f: BloomFilter) -> torch.Tensor:
    """Share of set bits, a 0-d float32 tensor."""
    return (ref.popcount(f.words).sum().to(torch.float64)
            / f.num_bits).to(torch.float32)


def pack_words(f: BloomFilter) -> torch.Tensor:
    """The dense (num_blocks, block_bits // 32) words: the port's state."""
    return f.words


def unpack_words(words, block_bits: int, k: int, seed: int,
                 device=None) -> BloomFilter:
    """A filter holding the given u32 words (numpy or torch; not copied
    when already an int32 tensor on ``device``)."""
    words = to_words(words, device)
    if words.ndim != 2 or words.shape[1] * 32 != block_bits:
        raise ValueError(f"words {tuple(words.shape)} do not hold "
                         f"{block_bits}-bit blocks")
    return BloomFilter(words=words, num_blocks=words.shape[0],
                       block_bits=block_bits, k=k, seed=seed)


def bits(f: BloomFilter) -> torch.Tensor:
    """The reference's state: (num_blocks, block_bits) uint8 in {0, 1}."""
    return ref.unpack_bits(f.words)
