"""Shared constants and capacity arithmetic for repro_torch.core.

WarpCore stores keys in-band: an ``EMPTY`` sentinel marks a never-occupied
slot and a ``TOMBSTONE`` marks a deleted one (paper §IV-B.5).  User keys must
avoid both sentinels.

Capacity follows the paper's cycle-freeness rule ``c = p * W`` with ``p``
prime (§IV-B.2): the table is a ``(p, W)`` array, one probe window per row.
At W = 32 one row of u32 keys is one warp's 128-byte line.

**Word representation.**  Every 32-bit key and value word is an unsigned
integer, but PyTorch implements ``>>``, ``%`` and ``minimum`` only for
signed integer types.  The port therefore keeps store planes and key /
value batches in ``torch.int32`` tensors that are bit-identical to u32
(what the CUDA kernels read as ``uint32_t``), and does hash and probe
arithmetic in ``torch.int64`` holding the u32 value (``as_u32``).  The
sentinels below are u32 values; ``*_WORD`` are the same bits as int32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# In-band sentinels (uint32 key plane).
EMPTY_KEY = 0xFFFFFFFF
TOMBSTONE_KEY = 0xFFFFFFFE
MAX_USER_KEY = 0xFFFFFFFD
# ... and their int32 bit patterns, as stored in the planes.
EMPTY_WORD = -1
TOMBSTONE_WORD = -2

# Insert status codes (per input element), the JAX package's codes.
STATUS_INSERTED = 0      # claimed a fresh slot
STATUS_UPDATED = 1       # key existed, value overwritten ("duplicate warning")
STATUS_FULL = 2          # probing exhausted without finding a slot
STATUS_MASKED = 3        # input element was masked out
STATUS_POOL_FULL = 4     # bucket-list: value pool exhausted

# Probe-window widths supported (paper CG sizes 1..32, and 64/128 as in
# the JAX package; the kernels walk W > 32 in 32-lane chunks).
SUPPORTED_WINDOWS = (1, 2, 4, 8, 16, 32, 64, 128)

DEFAULT_WINDOW = 32
DEFAULT_SEED = 0x9E3779B9

MASK32 = 0xFFFFFFFF


def is_prime(n: int) -> bool:
    if n < 2:
        return False
    if n % 2 == 0:
        return n == 2
    f = 3
    while f * f <= n:
        if n % f == 0:
            return False
        f += 2
    return True


def next_prime(n: int) -> int:
    """Smallest prime >= n."""
    n = max(2, int(n))
    while not is_prime(n):
        n += 1
    return n


def table_geometry(min_capacity: int, window: int) -> tuple[int, int]:
    """Return ``(num_rows, capacity)`` with num_rows prime and capacity = rows * window.

    Guarantees capacity >= min_capacity.  num_rows prime keeps double hashing
    over rows cycle-free (step sizes drawn from [1, p-1] generate Z_p).
    """
    if window not in SUPPORTED_WINDOWS:
        raise ValueError(f"window={window} not in {SUPPORTED_WINDOWS}")
    rows = next_prime(max(3, math.ceil(min_capacity / window)))
    return rows, rows * window


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor holding the unsigned 32-bit value of each word of ``x``."""
    return x.to(torch.int64) & MASK32


def as_word(x: torch.Tensor) -> torch.Tensor:
    """int32 tensor with the bits of the u32 values in the int64 tensor ``x``."""
    x = x & MASK32
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def to_words(x, device=None) -> torch.Tensor:
    """Coerce a batch of u32 words to an int32 tensor with the same bits.

    Accepts numpy ``uint32`` / ``int32`` arrays and torch ``int32`` /
    ``uint32`` tensors.
    """
    if isinstance(x, np.ndarray):
        if x.dtype not in (np.uint32, np.int32):
            raise TypeError(f"expected uint32 words, got numpy {x.dtype}")
        x = np.ascontiguousarray(x).view(np.int32)
        x = torch.from_numpy(x if x.flags.writeable else x.copy())
    elif not isinstance(x, torch.Tensor):
        raise TypeError(f"expected a numpy array or torch tensor, got {type(x)}")
    if x.dtype == torch.uint32:
        x = x.view(torch.int32)
    elif x.dtype != torch.int32:
        raise TypeError(f"expected uint32 words, got {x.dtype}")
    return x.to(device) if device is not None else x


def split_u64(x) -> tuple[torch.Tensor, torch.Tensor]:
    """Split 64-bit integers (numpy ``uint64`` arrays or torch ``uint64``
    tensors) into their (hi, lo) u32 planes, as int32 word tensors.  The
    tables store lo as plane 0, the plane that holds the sentinels, and hi
    as plane 1."""
    if isinstance(x, np.ndarray):
        if x.dtype != np.uint64:
            raise TypeError(f"expected uint64, got numpy {x.dtype}")
        x = torch.from_numpy(np.ascontiguousarray(x).view(np.int64))
    elif isinstance(x, torch.Tensor) and x.dtype == torch.uint64:
        x = x.view(torch.int64)       # the same bits; shifts work on int64
    else:
        raise TypeError(f"expected uint64, got {getattr(x, 'dtype', type(x))}")
    return as_word(x >> 32), as_word(x)


def join_u64(hi, lo) -> np.ndarray:
    """Join (hi, lo) u32 planes (int32 word tensors or numpy u32 arrays)
    into numpy ``uint64``."""
    hi, lo = (np.asarray(to_numpy_u32(p) if isinstance(p, torch.Tensor)
                         else p).astype(np.uint64) for p in (hi, lo))
    return (hi << np.uint64(32)) | lo


def to_numpy_u32(x: torch.Tensor) -> np.ndarray:
    """numpy uint32 copy of an int32 word tensor (any device).  A copy, not
    a view: the tables update their tensors in place."""
    return x.detach().cpu().numpy().view(np.uint32).copy()
