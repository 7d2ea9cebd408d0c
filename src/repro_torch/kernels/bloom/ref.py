"""The blocked bloom filter's arithmetic on a bit view, in plain PyTorch.

The port of ``repro.kernels.bloom.ref``, whose oracle is the bit-plane
implementation of ``repro.core.bloom``: one byte per bit, a
``(num_blocks, block_bits)`` row per block.  ``positions`` is the
reference's ``_positions``; ``unpack_bits`` / ``pack_bits`` convert
between the packed u32 words the port keeps (int32 tensors holding the
bits, bit j of a row in word j // 32 at bit j % 32, as
``repro.core.bloom.pack_words``) and that bit view.  The plain versions of
the kernels (``kernels.bloom.ops``) are built from these.

Hash arithmetic is int64 holding u32 values, masked to 32 bits (see
``core.common``), so the default seed 0x9E3779B9 and the step constant
0x61C88647 wrap as the kernel's ``uint32_t`` does.
"""

from __future__ import annotations

import torch

from repro_torch.core.common import MASK32, as_u32, as_word
from repro_torch.core.hashing import mix_murmur3, mix_xxhash

#: added to a key before the step hash of the double hashing
STEP_ADD = 0x61C88647

#: blocks per pass of ``unpack_bits`` / ``pack_bits`` (bounds their
#: temporaries: 2^16 blocks of 512 bits are 32 MiB of bits)
ROW_CHUNK = 1 << 16


def positions(keys: torch.Tensor, num_blocks: int, block_bits: int, k: int,
              seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(block (n,), bit (n, k))`` int64 for u32 ``keys``: the block
    murmur3(key ^ seed) mod num_blocks, and Kirsch-Mitzenmacher bits (h +
    i * g) mod 2^32 mod block_bits with h = xxhash(key ^ seed), g =
    murmur3(key + 0x61C88647)."""
    x = as_u32(keys)
    s = int(seed) & MASK32
    block = mix_murmur3(x ^ s) % num_blocks
    h = mix_xxhash(x ^ s)
    g = mix_murmur3((x + STEP_ADD) & MASK32)
    i = torch.arange(k, dtype=torch.int64, device=keys.device)
    bit = ((h[:, None] + i * g[:, None]) & MASK32) % block_bits
    return block, bit


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """(..., num_blocks, wpb) int32 words -> (..., num_blocks, 32 * wpb)
    uint8 bits."""
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    flat = words.reshape(-1, words.shape[-1])
    out = torch.empty((flat.shape[0], flat.shape[1] * 32), dtype=torch.uint8,
                      device=words.device)
    for s in range(0, flat.shape[0], ROW_CHUNK):
        w = as_u32(flat[s:s + ROW_CHUNK])
        out[s:s + ROW_CHUNK] = ((w[..., None] >> shifts) & 1).reshape(
            w.shape[0], -1)
    return out.reshape(*words.shape[:-1], -1)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Inverse of ``unpack_bits``: (..., num_blocks, block_bits) {0, 1}
    -> (..., num_blocks, block_bits // 32) int32 words."""
    if bits.shape[-1] % 32:
        raise ValueError(f"block_bits={bits.shape[-1]} is not a multiple "
                         "of 32")
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    flat = bits.reshape(-1, bits.shape[-1] // 32, 32)
    out = torch.empty(flat.shape[:2], dtype=torch.int32, device=bits.device)
    for s in range(0, flat.shape[0], ROW_CHUNK):
        b = flat[s:s + ROW_CHUNK].to(torch.int64)
        out[s:s + ROW_CHUNK] = as_word((b << shifts).sum(-1))
    return out.reshape(*bits.shape[:-1], -1)


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word, int64 (SWAR on the u32 value)."""
    x = as_u32(words)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK32) >> 24
