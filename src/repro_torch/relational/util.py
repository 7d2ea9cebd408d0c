"""Shared sizing and packing helpers of the relational operators,
``repro.relational.util``.

``pack_columns`` / ``unpack_columns`` (re-exported from
``core.hashing``) define the composite key encoding every operator
accepts: N u32 columns -> (n, N) key planes, column 0 most significant;
two columns are the table-native u64 (lo, hi) planes.  ``compact`` selects
rows of (n,) words or (n, key_words) planes alike.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.common import DEFAULT_WINDOW
from repro_torch.core.hashing import (  # noqa: F401  (re-exports — public API)
    pack_columns,
    unpack_columns,
)


def capacity_for(num_keys: int, load: float = 0.5,
                 window: int = DEFAULT_WINDOW) -> int:
    """min_capacity sizing: ``num_keys`` distinct entries at target load."""
    return max(int(math.ceil(max(num_keys, 1) / load)), window)


def compact(values: torch.Tensor, sel: torch.Tensor, out_capacity: int,
            fill=0) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack ``values[sel]`` into an ``out_capacity``-row output, in order.

    A cumsum gives each selected row its position; one scatter writes it
    into an ``out_capacity + 1`` buffer whose extra row takes the rows past
    the capacity and the unselected ones, and is dropped.  Returns
    (packed, n_selected as a 0-d int32 tensor); rows past ``n_selected``
    hold ``fill``.
    """
    pos = torch.cumsum(sel.to(torch.int64), 0) - 1
    slot = torch.where(sel & (pos < out_capacity), pos, out_capacity)
    out = torch.full((out_capacity + 1, *values.shape[1:]), fill,
                     dtype=values.dtype, device=values.device)
    out[slot] = values
    return out[:out_capacity], sel.sum(dtype=torch.int32)
