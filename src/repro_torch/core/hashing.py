"""Hash mixers and key-plane packing, bit-identical to ``repro.core.hashing``.

The paper uses two independent hash functions: ``h`` for the initial probe
row and ``g`` for the double-hashing step (§II, §IV-B.2).  These are the
murmur3 / xxhash32 avalanche mixers over u32 words.

Every function takes an integer tensor of u32 words (int32 bit patterns or
int64 values) and returns int64 values in [0, 2^32) (see ``common``).
Multiplication modulo 2^32 is split into 16-bit halves so that no int64
product overflows.  ``combine_planes`` folds a two-word key into the one
word its walk hashes; ``pack_columns`` / ``unpack_columns`` map composite
column keys to key planes and back.  The CUDA kernels compute the same
mixers and fold in ``uint32_t`` arithmetic (``kernels/cops/csrc/cops.cu``).
"""

from __future__ import annotations

import torch

from repro_torch.core.common import MASK32, as_u32, to_words

# murmur3 fmix32 constants
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
# xxhash32 primes (the second, independent mixer)
_X2 = 0x85EBCA77
_X3 = 0xC2B2AE3D
_X4 = 0x27D4EB2F
# modular inverses of the fmix32 multiply constants (odd => invertible)
_M1_INV = pow(_M1, -1, 1 << 32)
_M2_INV = pow(_M2, -1, 1 << 32)
# golden-ratio multiplier that derives the step mixer's seed
_STEP_SEED = 0x9E3779B1
# the additive constant of the plane fold (boost::hash_combine)
_COMBINE = 0x9E3779B9


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 ``x`` in [0, 2^32) and constant ``c``."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def mix_murmur3(x: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer — full avalanche."""
    x = as_u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 13)
    x = _mul32(x, _M2)
    return x ^ (x >> 16)


def unmix_murmur3(x: torch.Tensor) -> torch.Tensor:
    """Exact inverse of :func:`mix_murmur3` (fmix32 is a bijection on u32)."""
    x = as_u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, _M2_INV)
    x = x ^ (x >> 13) ^ (x >> 26)
    x = _mul32(x, _M1_INV)
    return x ^ (x >> 16)


def mix_xxhash(x: torch.Tensor) -> torch.Tensor:
    """xxhash32 avalanche — independent second mixer for double hashing."""
    x = as_u32(x)
    x = x ^ (x >> 15)
    x = _mul32(x, _X2)
    x = x ^ (x >> 13)
    x = _mul32(x, _X3)
    x = x ^ (x >> 16)
    return _mul32(x, _X4)


def combine_planes(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Fold a 64-bit key's (hi, lo) planes into one well-mixed u32 word:
    the probe word of every two-plane walk.  boost::hash_combine-style,
    asymmetric so (a, b) and (b, a) fold apart."""
    h = mix_murmur3(lo)
    return h ^ ((mix_murmur3(hi) + _COMBINE + (h << 6) + (h >> 2)) & MASK32)


# Composite multi-column keys: N u32 columns are stored as N key planes.
# Plane 0 (the one that holds the sentinels) is the LAST column, so for two
# columns the planes are bit for bit the (lo, hi) planes of the u64 key
# ``(col0 << 32) | col1``.

def pack_columns(columns) -> torch.Tensor:
    """Pack N (n,) u32 columns (numpy ``uint32`` / ``int32`` arrays or torch
    ``int32`` / ``uint32`` tensors) into an (n, N) int32 plane batch.
    Column 0 is the most significant and becomes plane N - 1."""
    if len(columns) == 0:
        raise ValueError("pack_columns needs at least one column")
    cols = [to_words(c) for c in columns]
    for i, c in enumerate(cols):
        if c.ndim != 1:
            raise ValueError(f"column {i} must be 1-D, got shape "
                             f"{tuple(c.shape)}")
    if any(c.shape != cols[0].shape for c in cols):
        raise ValueError("key columns must share one length")
    if len({c.device for c in cols}) != 1:
        raise ValueError("key columns must share one device")
    return torch.stack(cols[::-1], dim=1)


def unpack_columns(keys: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Inverse of :func:`pack_columns`: (n, N) planes -> N (n,) columns."""
    if keys.ndim == 1:
        keys = keys[:, None]
    kw = keys.shape[-1]
    return tuple(keys[..., kw - 1 - i] for i in range(kw))


def full_hash(key_word: torch.Tensor, seed: int) -> torch.Tensor:
    """The pre-modulo hash behind :func:`hash_rows`: murmur3(k ^ seed)."""
    return mix_murmur3(as_u32(key_word) ^ (int(seed) & MASK32))


def hash_rows(key_word: torch.Tensor, num_rows: int, seed: int) -> torch.Tensor:
    """Initial probe row: h1(k) in [0, num_rows)."""
    return full_hash(key_word, seed) % num_rows


def hash_step(key_word: torch.Tensor, num_rows: int, seed: int) -> torch.Tensor:
    """Double-hashing row step: g(k) in [1, num_rows-1].

    With num_rows prime every step generates Z_p, so the walk visits every
    row exactly once (§IV-B.2).
    """
    h = mix_xxhash(as_u32(key_word) ^ ((int(seed) * _STEP_SEED) & MASK32))
    return h % (num_rows - 1) + 1


def hash_owner(key_word: torch.Tensor, num_owners: int,
               seed: int = 0x5BD1E995) -> torch.Tensor:
    """Shard owner of each probe word, in [0, num_owners) (paper §IV-E):
    independent of ``hash_rows`` / ``hash_step``, so probing inside a shard
    stays uniform after the keys are partitioned by owner."""
    h = mix_xxhash(mix_murmur3(key_word) ^ (int(seed) & MASK32))
    return h % num_owners
